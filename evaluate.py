#!/usr/bin/env python
"""Quality evaluation entry point: rFID (Fréchet distance over recognizer
features) between generator samples and real data, plus recognizer CER.

Usage:
  python evaluate.py --workdir runs/demo [--synthetic-root runs/demo/synthetic_data]
      [--num-samples 256] [--bucket 5] [--set io.bucket_size=3] ...

Loads the latest full train-state checkpoint from <workdir>/checkpoints, draws
real batches from the bucketed dataset, generates matching fake batches, and
prints one JSON line: {"rfid": ..., "cer_real": ..., "num_samples": ...}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workdir", required=True)
    p.add_argument("--read-dir", default=None, help="bucketed dataset dir")
    p.add_argument("--style-dir", default=None)
    p.add_argument("--words-file", default=None)
    p.add_argument("--num-samples", type=int, default=256)
    p.add_argument("--bucket", default=None,
                   help="word-length bucket to evaluate, 'all' for a sweep "
                        "over every nonempty bucket (one JSON line each), or "
                        "a comma list (default: most populated)")
    p.add_argument("--config", default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = p.parse_args(argv)

    import jax

    from scrabblegan.config import load_config
    from scrabblegan.eval import (
        character_error_rate,
        compute_rfid,
        greedy_ctc_decode,
        recognizer_features,
    )
    from scrabblegan.train.loop import Trainer
    from scrabblegan.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    overrides = dict(kv.split("=", 1) for kv in args.set)
    # workdirs are self-describing (Trainer writes config.json at the root);
    # an explicit --config wins, --set applies on top either way
    from scrabblegan.config import discover_config

    cfg_path = args.config or discover_config(args.workdir, max_up=0)
    if cfg_path and not args.config:
        print(f"using discovered config: {cfg_path}", file=sys.stderr)
    cfg = load_config(cfg_path, overrides)

    trainer = Trainer(cfg, workdir=args.workdir, verbose=False)
    default_root = os.path.join(args.workdir, "synthetic_data")
    if args.read_dir is None and os.path.isdir(default_root):
        trainer.load_data(
            read_dir=os.path.join(default_root, "words-Reading"),
            style_dir=os.path.join(default_root, "style_imgs"),
            words_file=os.path.join(default_root, "random_words.txt"))
    else:
        trainer.load_data(read_dir=args.read_dir, style_dir=args.style_dir,
                          words_file=args.words_file)
    state = trainer.init_state(resume=True)
    if int(jax.device_get(state.step)) == 0:
        print(json.dumps({"error": "no checkpoint found in workdir"}))
        return 1

    ds = trainer.dataset
    if args.bucket == "all":
        buckets = sorted(ds.nonempty)
    elif args.bucket:
        buckets = [int(b) for b in str(args.bucket).split(",")]
    else:
        buckets = [max(ds.nonempty, key=lambda b: len(ds.labels[b]))]
    n = args.num_samples
    bsz = cfg.shared.batch_size

    np_rng = np.random.default_rng(cfg.seed + 42)
    from scrabblegan.data.loaders import sample_fake_labels

    # EMA states need standing statistics (Trainer.standing_stats docstring);
    # None for non-EMA states -> generate() serves the live stats
    serve_stats = trainer.standing_stats(state)
    extractor = recognizer_features(trainer.models.recognizer,
                                    state.r_params, state.r_stats)
    rec = trainer.models.recognizer
    rec_vars = {"params": state.r_params, "batch_stats": state.r_stats}
    jit_rec = jax.jit(lambda v, imgs: rec.apply(v, imgs, train=False))

    def cer_of(imgs, want_rows, bucket):
        logits = np.concatenate([
            np.asarray(jit_rec(rec_vars, imgs[i:i + bsz]))
            for i in range(0, len(imgs), bsz)])
        preds = greedy_ctc_decode(
            logits, np.full((len(imgs),), 4 * bucket - 1, np.int32))
        return character_error_rate(preds, want_rows)

    for bucket in buckets:
        real_imgs, real_labels = [], []
        gen_imgs, gen_labels = [], []
        while sum(len(x) for x in real_imgs) < n:
            imgs, labels, _ = ds.sample_batch(bsz, bucket=bucket)
            real_imgs.append(imgs)
            real_labels.append(labels)
            fake = sample_fake_labels(np_rng, trainer.random_words, bsz, bucket)
            style_idx = np_rng.integers(0, len(trainer.style_train), size=bsz)
            style = np.stack(
                [trainer.style_train[i] for i in style_idx])[..., None]
            out = trainer.generate(state, fake, stats=serve_stats,
                                   style_imgs=style.astype(np.float32),
                                   z=np.asarray(jax.random.normal(
                                       jax.random.PRNGKey(len(gen_imgs)),
                                       (bsz, cfg.shared.latent_dim))))
            gen_imgs.append(np.asarray(out, np.float32))
            gen_labels.append(fake)

        real_imgs = np.concatenate(real_imgs)[:n]
        gen_imgs = np.concatenate(gen_imgs)[:n]
        real_labels = np.concatenate(real_labels)[:n]
        gen_labels = np.concatenate(gen_labels)[:n]

        rfid = compute_rfid(gen_imgs, real_imgs, extractor, batch_size=bsz)
        cer = cer_of(real_imgs, [list(l) for l in real_labels], bucket)
        cer_gen = cer_of(gen_imgs,
                         [list(map(int, row)) for row in gen_labels], bucket)

        print(json.dumps({
            "rfid": round(rfid, 4),
            "cer_real": round(cer, 4),
            "cer_gen": round(cer_gen, 4),
            "bucket": int(bucket),
            "num_samples": int(n),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

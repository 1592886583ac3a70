"""Diagnose the pmema late-run quality collapse: is it the live G, or the
EMA-weights/live-BN-stats mismatch in the export?

Scores three generator variants from the FINAL full-state checkpoint of a
g_ema_decay run, with the campaign's exact protocol (512 samples, bucket 5,
final-R extractor):

  live      live params + live BN stats        (what a pm export serves)
  ema_live  EMA params  + live BN stats        (what pmema exported)
  ema_stand EMA params  + STANDING stats        (BigGAN arXiv:1809.11096:
            refresh the BN running stats by running train-mode forwards
            under the EMA weights before serving)

Usage: python scripts/ema_standing_stats_ab.py \
           [--workdir runs/quality/pmema] [--root runs/quality]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

EVAL_BUCKET = 5


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="runs/quality/pmema")
    p.add_argument("--root", default="runs/quality")
    p.add_argument("--num-samples", type=int, default=512)
    p.add_argument("--standing-batches", type=int, default=300)
    args = p.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from scrabblegan.config import load_config
    from scrabblegan.data.loaders import sample_fake_labels
    from scrabblegan.eval import (
        character_error_rate,
        compute_rfid,
        greedy_ctc_decode,
        recognizer_features,
    )
    from scrabblegan.train.loop import Trainer
    from scrabblegan.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    cfg = load_config(None, {"parallel.shape_mode": "padded",
                             "parallel.bucket_pairing": "matched",
                             "optimizer.g_ema_decay": 0.999})
    trainer = Trainer(cfg, workdir=args.workdir, verbose=False)
    data_root = os.path.join(args.root, "data")
    trainer.load_data(read_dir=os.path.join(data_root, "words-Reading"),
                      style_dir=os.path.join(data_root, "style_imgs"),
                      words_file=os.path.join(data_root, "random_words.txt"))
    state = trainer.init_state(resume=True)
    print(f"restored step {int(jax.device_get(state.step))}", flush=True)

    extractor = recognizer_features(trainer.models.recognizer,
                                    state.r_params, state.r_stats)
    gen = trainer.models.generator
    rec = trainer.models.recognizer
    rec_vars = {"params": state.r_params, "batch_stats": state.r_stats}
    jit_rec = jax.jit(lambda v, imgs: rec.apply(v, imgs, train=False))
    jit_gen = jax.jit(lambda v, labels, cond: gen.apply(
        v, labels, train=False, style_imgs=cond))

    n = args.num_samples
    rng = np.random.default_rng(123)
    real_imgs = []
    while sum(len(x) for x in real_imgs) < n:
        imgs, _, _ = trainer.dataset.sample_batch(64, bucket=EVAL_BUCKET)
        real_imgs.append(imgs)
    real_imgs = np.concatenate(real_imgs)[:n]
    eval_labels = sample_fake_labels(rng, trainer.random_words, n, EVAL_BUCKET)
    style_idx = rng.integers(0, len(trainer.style_train), size=n)
    eval_style = np.stack([trainer.style_train[i] for i in style_idx])[..., None]
    eval_style = eval_style.astype(np.float32)

    live = jax.device_get(state.g_params)
    ema = jax.device_get(state.g_ema)
    live_stats = jax.device_get(state.g_stats)

    def standing_stats(params, batches):
        """BigGAN standing statistics: refresh BN running stats under the
        given weights with train-mode forwards on real conditioning."""
        srng = np.random.default_rng(7)

        @jax.jit
        def one(stats, labels, style):
            _, muts = gen.apply({"params": params, "batch_stats": stats},
                                labels, train=True, mutable=["batch_stats"],
                                style_imgs=style)
            return muts["batch_stats"]

        stats = live_stats
        bsz = 16
        for i in range(batches):
            labels = sample_fake_labels(srng, trainer.random_words, bsz,
                                        EVAL_BUCKET)
            idx = srng.integers(0, len(trainer.style_train), size=bsz)
            style = np.stack([trainer.style_train[j] for j in idx])[..., None]
            stats = one(stats, labels, style.astype(np.float32))
        return jax.device_get(stats)

    def score(tag, params, stats):
        variables = {"params": params, "batch_stats": stats}
        outs = []
        for i in range(0, n, 64):
            outs.append(np.asarray(jit_gen(variables, eval_labels[i:i + 64],
                                           eval_style[i:i + 64]), np.float32))
        gen_imgs = np.concatenate(outs, 0)
        rfid = compute_rfid(gen_imgs, real_imgs, extractor, batch_size=64)
        t_frames = 4 * EVAL_BUCKET - 1
        logits = np.concatenate([
            np.asarray(jit_rec(rec_vars, gen_imgs[i:i + 64]))
            for i in range(0, n, 64)])
        preds = greedy_ctc_decode(logits, np.full((n,), t_frames, np.int32))
        want = [list(map(int, row)) for row in eval_labels]
        cer = character_error_rate(preds, want)
        row = {"variant": tag, "rfid": round(rfid, 4), "cer_gen": round(cer, 4)}
        print(json.dumps(row), flush=True)
        return row

    score("live", live, live_stats)
    score("ema_live", ema, live_stats)
    stand = standing_stats(ema, args.standing_batches)
    score("ema_standing", ema, stand)
    return 0


if __name__ == "__main__":
    sys.exit(main())

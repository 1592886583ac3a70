#!/usr/bin/env python
"""Training entry point (parity with reference src/main.py).

Usage:
  python train.py [--config cfg.json] [--set shared.epochs=2] [--synthetic]

- converts the raw dataset to GAN-Reading format on first run (main.py:61-63),
- builds data loaders, the four networks, optimizers, and the jitted step,
- trains with per-epoch sample grids, checkpoints (with resume), and
  generator-only exports, then writes the training animation.
`--synthetic` fabricates a tiny on-disk dataset first — the zero-download way to
exercise the full path.
"""

from __future__ import annotations

import argparse
import os
import sys


def resolve_default_config() -> str | None:
    """The config used when --config is not given: configs/recommended.json —
    the quality-recommended regime (padded shape mode + EMA + trunk-bf16).

    The library dataclass defaults keep exact reference semantics
    (parallel.shape_mode='bucketed'), but the 12-arm quality campaign showed
    that regime COLLAPSES past ~1 epoch on every arm while the padded regime
    trains stably (docs/QUALITY.md rounds 3-4) — so the bare CLI must not ship
    it as the silent default. `--config none` opts back into the
    reference-exact defaults."""
    candidate = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "configs", "recommended.json")
    return candidate if os.path.isfile(candidate) else None


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", default=None,
                   help="JSON config file (default: configs/recommended.json, "
                        "the quality-recommended regime; pass 'none' for the "
                        "reference-exact library defaults)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="dotted config override, e.g. optimizer.g_lr=1e-4")
    p.add_argument("--workdir", default=None, help="output root (default io.base_path)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batches-per-epoch", type=int, default=None)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--profile", type=int, default=0, metavar="N",
                   help="trace the first N train dispatches with jax.profiler "
                        "(written to <workdir>/output/trace) and print steps/s")
    p.add_argument("--synthetic", action="store_true",
                   help="generate and train on a synthetic dataset fixture")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from scrabblegan.config import load_config
    overrides = dict(kv.split("=", 1) for kv in args.set)
    config_path = args.config
    if config_path is None:
        config_path = resolve_default_config()
        if config_path:
            print(f"using {config_path} (the quality-recommended regime); "
                  f"pass --config none for reference-exact defaults")
    elif config_path.lower() in ("none", ""):
        config_path = None
    cfg = load_config(config_path, overrides)

    from scrabblegan.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from scrabblegan.train.loop import Trainer

    trainer = Trainer(cfg, workdir=args.workdir)

    if args.synthetic:
        from scrabblegan.data.synthetic import make_synthetic_dataset

        root = os.path.join(args.workdir or cfg.io.base_path, "synthetic_data")
        read_dir, words_file, style_dir = make_synthetic_dataset(root)
        trainer.load_data(read_dir=read_dir, style_dir=style_dir,
                          words_file=words_file)
    else:
        if not os.path.exists(cfg.io.read_dir):
            print("converting dataset to GAN-Reading format...")
            from scrabblegan.data.iam import DATASET_HANDLERS

            DATASET_HANDLERS[cfg.io.dataset](
                cfg.io.raw_dir, cfg.io.read_dir, cfg.io.input_dim,
                cfg.io.bucket_size)
        trainer.load_data()

    trainer.train(epochs=args.epochs, batches_per_epoch=args.batches_per_epoch,
                  resume=not args.no_resume, profile_steps=args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())

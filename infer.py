#!/usr/bin/env python
"""Inference entry point: arbitrary word string -> handwritten word images.

API parity with reference src/run_inference.py: load a generator export, encode a
sample string via char_vector indexing, run the generator in inference mode on
[latent, labels], rescale [-1,1] -> [0,1], and save an n-row image grid. Supports
BOTH latent sources (SURVEY.md defect #10): sampled z (the reference script's
128-d noise, upstream ScrabbleGAN G) and a style image (this fork's G).

Usage:
  python infer.py --model-dir runs/model --word machinelearning -n 10 \
      [--z-source noise|style] [--style-image path.png] [--out out.png]

The model dir is SELF-DESCRIBING: the Trainer writes config.json next to every
export, and this script auto-loads it (then applies --set on top), so a
generator trained in 'padded' shape mode (extra filter-bank PAD row) or with
weight EMA restores with zero manual flags. An explicit --config wins over the
discovered one.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def make_apply(generator):
    """The jitted inference callable: an un-jitted generator.apply dispatches
    op-by-op; one jit makes the whole forward a single dispatch (reference:
    run_inference.py:35)."""
    import jax

    @jax.jit
    def apply_fn(variables, labels, **kwargs):
        return generator.apply(variables, labels, train=False, **kwargs)

    return apply_fn


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-dir", required=True,
                   help="model dir containing generator/<epoch>/, or a direct export path")
    p.add_argument("--word", default="machinelearning")
    p.add_argument("-n", "--num-samples", type=int, default=10)
    p.add_argument("--z-source", default=None, choices=["noise", "style"],
                   help="default: the config the model was trained with")
    p.add_argument("--style-image", default=None, help="style image for z-source=style")
    p.add_argument("--out", default="inference.png")
    p.add_argument("--export", default="auto", choices=["auto", "latest"],
                   help="'auto' (default) serves the newest KNOWN-GOOD export "
                        "when the training-time quality gate flagged any "
                        "(model/generator/latest_good); 'latest' forces the "
                        "newest epoch regardless of its gate flag")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--config", default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import jax

    from scrabblegan.utils.cache import enable_compilation_cache

    enable_compilation_cache()  # repeated infer invocations reuse the compile

    from scrabblegan.config import discover_config, load_config
    from scrabblegan.data.loaders import encode_word
    from scrabblegan.data.images import read_grayscale, resize
    from scrabblegan.train.checkpoint import latest_generator_export, load_generator
    from scrabblegan.train.state import build_models
    from scrabblegan.utils.viz import save_image_grid

    overrides = dict(kv.split("=", 1) for kv in args.set)
    cfg_path = args.config or discover_config(args.model_dir)
    if cfg_path and not args.config:
        print(f"using discovered config: {cfg_path}")
    cfg = load_config(cfg_path, overrides)
    if args.z_source:
        from dataclasses import replace

        cfg = replace(cfg, shared=replace(cfg.shared, z_source=args.z_source))

    export = latest_generator_export(args.model_dir) or args.model_dir
    if args.export == "auto":
        from scrabblegan.eval.gate import latest_good_export

        good = latest_good_export(args.model_dir)
        if good and os.path.realpath(good) != os.path.realpath(export):
            print(f"serving latest KNOWN-GOOD export {good} (newest epoch is "
                  f"gate-flagged; --export latest overrides)")
            export = good
    variables = load_generator(export)
    generator = build_models(cfg).generator

    n = args.num_samples
    labels = np.asarray([encode_word(args.word, cfg.io.char_vec)] * n, np.int32)

    kwargs = {}
    if cfg.shared.z_source == "style":
        h, w, _ = cfg.io.input_dim
        if args.style_image:
            img = read_grayscale(args.style_image).astype(np.float32)
            rate = h / img.shape[0]
            img = resize(img, max(1, int(img.shape[1] * rate)), h)
            canvas = np.full((h, w), 255.0, np.float32)
            canvas[:, : min(w, img.shape[1])] = img[:, :w]
            style = (canvas - 127.5) / 127.5
        else:
            style = np.ones((h, w), np.float32)  # blank white page
        kwargs["style_imgs"] = np.broadcast_to(style[None, ..., None],
                                               (n, h, w, 1)).astype(np.float32)
    else:
        key = jax.random.PRNGKey(args.seed)
        kwargs["z"] = jax.random.normal(key, (n, cfg.shared.latent_dim))

    preds = make_apply(generator)(variables, labels, **kwargs)
    preds = np.asarray(preds)
    save_image_grid(preds, args.out, grid=(n, 1))
    print(f"wrote {args.out}: {preds.shape[0]} samples of '{args.word}' "
          f"({preds.shape[1]}x{preds.shape[2]}px)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Export a trained generator as a self-contained StableHLO serving bundle
(the analog of the reference's tf.saved_model export consumed by
run_inference.py).

Usage:
  python export_model.py --model-dir runs/demo/model --out runs/demo/export \
      --batch-size 16 --length 5 [--z-source noise|style] [--set KEY=VALUE]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model-dir", required=True,
                   help="dir containing generator/<epoch>/ exports (or a direct path)")
    p.add_argument("--out", required=True)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--length", type=int, default=5)
    p.add_argument("--z-source", default=None, choices=["noise", "style"])
    p.add_argument("--config", default=None)
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    args = p.parse_args(argv)

    from scrabblegan.config import discover_config, load_config
    from scrabblegan.train.checkpoint import latest_generator_export, load_generator
    from scrabblegan.train.export import export_generator
    from scrabblegan.train.state import build_models

    overrides = dict(kv.split("=", 1) for kv in args.set)
    # model dirs are self-describing (Trainer writes config.json next to every
    # export); an explicit --config wins, --set applies on top either way
    cfg_path = args.config or discover_config(args.model_dir)
    if cfg_path and not args.config:
        print(f"using discovered config: {cfg_path}")
    cfg = load_config(cfg_path, overrides)
    if args.z_source:
        from dataclasses import replace

        cfg = replace(cfg, shared=replace(cfg.shared, z_source=args.z_source))

    export = latest_generator_export(args.model_dir) or args.model_dir
    from scrabblegan.eval.gate import latest_good_export

    good = latest_good_export(args.model_dir)
    if good and os.path.realpath(good) != os.path.realpath(export):
        print(f"serving latest KNOWN-GOOD export {good} (newest epoch is "
              f"gate-flagged)")
        export = good
    variables = load_generator(export)
    generator = build_models(cfg).generator
    h, w, _ = cfg.io.input_dim
    out = export_generator(args.out, generator, variables, args.batch_size,
                           args.length, cfg.shared.z_source,
                           cfg.shared.latent_dim, (h, w))
    print(f"wrote serving bundle: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Short-bucket rFID inflation: metric degeneracy or real quality gap?
(VERDICT r4 item 7 / weak #8.)

The pmtb ep10 per-length sweep showed rFID 523/170/84 at len 1/2/3 falling to
a 41-48 plateau from len-6, with CER(gen)=0 everywhere. Two hypotheses:
(a) the width-pooled feature statistics DEGENERATE at 16-80 px widths — the
metric inflates mechanically; (b) short-word generation genuinely lags.

Decisive A/B: the REAL-vs-REAL Fréchet floor per bucket. Disjoint halves of
the same real data share one distribution, so any nonzero distance is pure
estimator behavior at that width/sample count. If the floor inflates at short
lengths like the gen-vs-real numbers do, the inflation is the metric, not the
model.

Usage:
  JAX_PLATFORMS=cpu python scripts/rfid_floor_study.py \
      --read-dir runs/quality/data/words-Reading \
      --recognizer runs/quality/pmtb/model/recognizer/10 \
      [--out docs/quality/rfid_floor.json]

Writes one JSON artifact with, per bucket: the real-real floor under BOTH
extractors (trained-R rFID and the fixed random_features axis), at the
sweep's sample count.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_bucket(read_dir: str, bucket: int) -> np.ndarray:
    from scrabblegan.data.images import read_grayscale

    d = os.path.join(read_dir, str(bucket))
    imgs = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".png"):
            img = read_grayscale(os.path.join(d, fn))
            if img is not None:
                imgs.append(img)
    arr = np.stack(imgs).astype(np.float32)[..., None]
    return (arr - 127.5) / 127.5


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--read-dir", default="runs/quality/data/words-Reading")
    p.add_argument("--recognizer", default="runs/quality/pmtb/model/recognizer/10")
    p.add_argument("--out", default="docs/quality/rfid_floor.json")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from scrabblegan.config import Config
    from scrabblegan.eval import compute_rfid, random_features, recognizer_features
    from scrabblegan.train.checkpoint import load_recognizer
    from scrabblegan.train.state import build_models

    rec = build_models(Config()).recognizer
    rec_vars = load_recognizer(args.recognizer)
    rec_extract = recognizer_features(rec, rec_vars["params"],
                                      rec_vars["batch_stats"])
    rand_extract = random_features()

    rng = np.random.default_rng(args.seed)
    rows = []
    for bucket in range(1, 11):
        d = os.path.join(args.read_dir, str(bucket))
        if not os.path.isdir(d):
            continue
        imgs = load_bucket(args.read_dir, bucket)
        idx = rng.permutation(len(imgs))
        half = len(imgs) // 2
        a, b = imgs[idx[:half]], imgs[idx[half:2 * half]]
        floor_rec = compute_rfid(a, b, rec_extract, batch_size=64)
        floor_rand = compute_rfid(a, b, rand_extract, batch_size=64)
        # also a split-half at the sweep's nominal N (512 with replacement)
        # to mirror its estimator variance exactly
        ia = rng.integers(0, half, size=512)
        ib = rng.integers(half, 2 * half, size=512)
        floor_rec_512 = compute_rfid(imgs[idx[ia]], imgs[idx[ib]],
                                     rec_extract, batch_size=64)
        row = {
            "bucket": bucket,
            "n_half": int(half),
            "floor_rfid_rec": round(float(floor_rec), 2),
            "floor_rfid_rec_n512": round(float(floor_rec_512), 2),
            "floor_rfid_rand": round(float(floor_rand), 3),
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = {
        "what": "real-vs-real Frechet floors per word-length bucket "
                "(disjoint halves of the same distribution)",
        "data": args.read_dir,
        "recognizer_export": args.recognizer,
        "rows": rows,
    }
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Offline loss-curve plotting (parity with reference src/utilities.py).

Usage: python plot_losses.py --base-path runs/output [--gradient-balance] [--no-per-batch]
"""

import argparse
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base-path", required=True)
    p.add_argument("--gradient-balance", action="store_true")
    p.add_argument("--no-per-batch", action="store_true")
    args = p.parse_args(argv)

    from scrabblegan.utils.plotting import plot_losses

    outputs = plot_losses(args.base_path, info_per_batch=not args.no_per_batch,
                          gradient_balance=args.gradient_balance)
    for o in outputs:
        print(f"wrote {o}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

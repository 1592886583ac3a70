#!/usr/bin/env python
"""Time the fused attention kernel against the plain XLA attention, end to end
inside the generator and the train step, on one GPU.

    python scripts/attention_ab.py [--section inference|train|tune|all]

tune:      the kernel alone over tile sizes, warps and pipeline stages at the
           len-10 generator attention, batch 1024 bf16 and batch 16 f32.
inference: generator forward, batch 1024, bf16, sampled z, word lengths 5, 10.
train:     the full four-network train step at batch 16 under
           configs/recommended.json (padded 160 px canvas, word length 10),
           and the same config bucketed at word length 5.
Variants run in the order kernel, xla, xla, kernel; each number is the
median over timed windows after a warm-up, and the card's name and power
limit are printed beside them. Values of the parameters are random.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def window_time(fn, n: int, windows: int = 3) -> float:
    """Median over `windows` of the mean seconds per call of n chained calls."""
    import jax

    jax.block_until_ready(fn())
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n):
            r = fn()
        jax.block_until_ready(r)
        out.append((time.perf_counter() - t0) / n)
    return float(np.median(out))


def inference(length: int) -> dict:
    import jax
    import jax.numpy as jnp

    from scrabblegan.config import Config, SharedSpecs
    from scrabblegan.train.state import build_models
    from scrabblegan.utils.fakeparams import fake_variables

    cfg = Config(shared=dataclasses.replace(SharedSpecs(), dtype="bfloat16",
                                            z_source="noise"))
    labels = jnp.zeros((1024, length), jnp.int32)
    z = jax.random.normal(jax.random.PRNGKey(0), (1024, cfg.shared.latent_dim))
    variables = None
    fns = {}
    for use_kernel in (True, False):
        gen = build_models(cfg, use_pallas_attention=use_kernel).generator
        if variables is None:
            variables = fake_variables(jax.eval_shape(
                lambda: gen.init(jax.random.PRNGKey(0), labels, z=z, train=False)))
        fns[use_kernel] = jax.jit(lambda v, l, z, g=gen: g.apply(v, l, z=z, train=False))
    times = {True: [], False: []}
    for use_kernel in (True, False, False, True):
        times[use_kernel].append(
            window_time(lambda: fns[use_kernel](variables, labels, z), 20))
    return {k: float(np.mean(v)) for k, v in times.items()}


def tune() -> None:
    import itertools

    import jax
    import jax.numpy as jnp

    from scrabblegan.kernels import attention as ka

    q, k = 5120, 1280
    for b, dtype in ((1024, jnp.bfloat16), (16, jnp.float32)):
        keys = jax.random.split(jax.random.PRNGKey(0), 3)
        args = [jax.random.normal(kk, (b, n, c), jnp.float32).astype(dtype)
                for kk, n, c in zip(keys, (q, k, k), (8, 8, 32))]
        results = []
        for bq, bk, warps, stages in itertools.product(
                (32, 64, 128), (64, 128), (4, 8), (2, 3)):
            fn = jax.jit(lambda *a, c=(bq, bk, warps, stages): ka.triton_attention(
                *a, tiles=c))
            try:
                t = window_time(lambda: fn(*args), 10)
            except Exception as e:  # noqa: BLE001 — a config the compiler refuses
                print(f"tune B={b} {jnp.dtype(dtype).name} bq={bq} bk={bk} "
                      f"warps={warps} stages={stages}: failed {type(e).__name__}")
                continue
            results.append((t, bq, bk, warps, stages))
        for t, bq, bk, warps, stages in sorted(results)[:6]:
            print(f"tune B={b} {jnp.dtype(dtype).name} Q={q} K={k}: bq={bq} bk={bk} "
                  f"warps={warps} stages={stages}: {t * 1e3:.3f} ms", flush=True)
        default = [r for r in results if r[1:] == ka.TILES[jnp.dtype(dtype)]]
        print(f"tune B={b} {jnp.dtype(dtype).name}: current default "
              f"{default[0][0] * 1e3:.3f} ms" if default else "default not run",
              flush=True)


def train(length: int) -> dict:
    import jax

    from scrabblegan.config import load_config
    from scrabblegan.parallel.mesh import (batch_sharding, make_mesh,
                                           make_parallel_train_step)
    from scrabblegan.train.state import build_models, create_train_state
    from scrabblegan.utils.fakeparams import fake_variables

    overrides = {} if length == 10 else {"parallel.shape_mode": "bucketed"}
    cfg = load_config(os.path.join(ROOT, "configs", "recommended.json"), overrides)
    b = cfg.shared.batch_size
    rng = np.random.default_rng(0)
    batch = {
        "real_imgs": rng.integers(0, 256, (b, 32, 16 * length, 1)).astype(np.uint8),
        "real_labels": rng.integers(0, 52, (b, length)).astype(np.int32),
        "style_imgs": rng.integers(0, 256, (b, 32, 160, 1)).astype(np.uint8),
        "fake_labels": rng.integers(0, 52, (b, length)).astype(np.int32),
    }
    if cfg.parallel.shape_mode == "padded":
        batch["real_lengths"] = rng.integers(1, length + 1, (b,)).astype(np.int32)
        batch["fake_lengths"] = rng.integers(1, length + 1, (b,)).astype(np.int32)
    mesh = make_mesh(1)
    batch = jax.device_put(batch, batch_sharding(mesh))
    holder = {}
    steps = {}
    for use_kernel in (True, False):
        models = build_models(cfg, use_pallas_attention=use_kernel)
        if not holder:
            holder["state"] = jax.device_put(fake_variables(jax.eval_shape(
                lambda: create_train_state(cfg, jax.random.PRNGKey(0), models))))
        steps[use_kernel] = make_parallel_train_step(cfg, models, mesh)

    def run(step):
        holder["state"], metrics = step(holder["state"], batch, jax.random.PRNGKey(1))
        return metrics

    times = {True: [], False: []}
    for use_kernel in (True, False, False, True):
        times[use_kernel].append(window_time(lambda: run(steps[use_kernel]), 20))
    return {k: float(np.mean(v)) for k, v in times.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--section", default="all",
                   choices=["tune", "inference", "train", "all"])
    args = p.parse_args(argv)

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"no GPU found (devices: {jax.devices()})", file=sys.stderr)
        return 1
    from scrabblegan.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    where = f"{card()}; {jax.devices()[0].device_kind}"
    if args.section in ("tune", "all"):
        print(f"[{where}]")
        tune()
    sections = [("inference", inference), ("train", train)]
    for name, fn in sections:
        if args.section not in (name, "all"):
            continue
        for length in (5, 10):
            t = fn(length)
            unit = "images/s" if name == "inference" else "steps/s"
            per = 1024 if name == "inference" else 1
            print(f"{name} len {length}: kernel {t[True] * 1e3:.3f} ms "
                  f"({per / t[True]:.1f} {unit}), xla {t[False] * 1e3:.3f} ms "
                  f"({per / t[False]:.1f} {unit}), kernel/xla time "
                  f"{t[True] / t[False]:.3f} [{where}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

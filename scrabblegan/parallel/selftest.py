"""Data-parallel parity selftest: mesh=N numerics must match mesh=1 (SURVEY.md §5
parity criterion for the new parallelism component).

Runs as `python -m scrabblegan.parallel.selftest [n_devices]` and prints
'PARITY-OK' on success. Kept subprocess-runnable because XLA:CPU's multi-replica
rendezvous can hard-abort the host process under load (a CHECK failure, not a
Python exception) — the test suite invokes this in a child process so an abort
fails one test instead of killing the run.
"""

from __future__ import annotations

import dataclasses
import os
import sys


def run(n_devices: int = 8) -> bool:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        flags += f" --xla_force_host_platform_device_count={n_devices}"
    if "collective_call_terminate" not in flags:
        flags += (" --xla_cpu_collective_timeout_seconds=1200"
                  " --xla_cpu_collective_call_terminate_timeout_seconds=1200")
    os.environ["XLA_FLAGS"] = flags.strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    from scrabblegan.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import numpy as np

    from scrabblegan.config import Config, OptimizerConfig, ParallelConfig, SharedSpecs
    from scrabblegan.parallel.mesh import make_mesh, make_parallel_train_step
    from scrabblegan.train.state import build_models, create_train_state
    from scrabblegan.train.step import METRIC_NAMES

    b, length, n_steps = n_devices, 2, 4
    cfg = Config(
        optimizer=OptimizerConfig(),
        shared=dataclasses.replace(SharedSpecs(), batch_size=b),
        parallel=ParallelConfig(num_devices=1),
    )
    models = build_models(cfg)
    state0 = create_train_state(cfg, jax.random.PRNGKey(0), models)
    rng = np.random.default_rng(0)

    def draw_batch(bsz):
        return {
            "real_imgs": rng.uniform(-1, 1, (bsz, 32, 16 * length, 1)).astype(np.float32),
            "real_labels": rng.integers(0, 52, (bsz, length)).astype(np.int32),
            "style_imgs": rng.uniform(-1, 1, (bsz, 32, 160, 1)).astype(np.float32),
            "fake_labels": rng.integers(0, 52, (bsz, length)).astype(np.int32),
        }

    batches = [draw_batch(b) for _ in range(n_steps)]
    keys = [jax.random.PRNGKey(2 + i) for i in range(n_steps)]

    step1 = make_parallel_train_step(cfg, models, make_mesh(1), donate=False)
    stepn = make_parallel_train_step(cfg, models, make_mesh(n_devices), donate=False)

    # ---- multi-step parity: BN-stat and SN-u drift ACCUMULATES across steps,
    # so mesh=N must track mesh=1 through a trajectory, not just one update.
    # Expected divergence source: XLA's SPMD all-reduce sums per-device partial
    # reductions in tree order vs the single-device flat reduction — f32
    # rounding of order ~eps*sqrt(#terms)*|value|, amplified by the updates.
    # Measured on this backend (printed below): per-step metric rel-diff
    # ~1e-6..1e-4; param maxdiff ~1e-6 after step 1, ~1e-4..1e-3 by step 4.
    # Asserted bounds leave ~10x headroom over measurements.
    ok = True
    s1, sn = state0, state0
    for i in range(n_steps):
        s1, m1 = step1(s1, batches[i], keys[i])
        sn, mn = stepn(sn, batches[i], keys[i])
        worst_key, worst_rel = "", 0.0
        for k in METRIC_NAMES:
            a, c = float(m1[k]), float(mn[k])
            rel = abs(a - c) / max(abs(a), 1e-4)
            if rel > worst_rel:
                worst_key, worst_rel = k, rel
            if not np.isclose(a, c, rtol=2e-3, atol=2e-4):
                print(f"step {i}: MISMATCH {k}: mesh1={a} mesh{n_devices}={c}")
                ok = False
        maxd = max(float(np.abs(np.asarray(x) - np.asarray(y)).max())
                   for x, y in zip(jax.tree_util.tree_leaves(jax.device_get(s1.g_params)),
                                   jax.tree_util.tree_leaves(jax.device_get(sn.g_params))))
        print(f"step {i}: metric max rel-diff {worst_rel:.2e} ({worst_key}); "
              f"g_param maxdiff {maxd:.2e}")
        if maxd > 5e-3:
            print(f"step {i}: PARAM MISMATCH maxdiff={maxd}")
            ok = False

    # ---- weak scaling: 8 samples/device instead of 1 — the sharded reduction
    # covers real per-device subtensors; parity must hold at this batch too.
    big = 8 * n_devices
    cfg_big = dataclasses.replace(
        cfg, shared=dataclasses.replace(cfg.shared, batch_size=big))
    step1b = make_parallel_train_step(cfg_big, models, make_mesh(1), donate=False)
    stepnb = make_parallel_train_step(cfg_big, models, make_mesh(n_devices),
                                      donate=False)
    bb = draw_batch(big)
    kb = jax.random.PRNGKey(99)
    _, m1b = step1b(state0, bb, kb)
    _, mnb = stepnb(state0, bb, kb)
    worst = max(abs(float(m1b[k]) - float(mnb[k])) / max(abs(float(m1b[k])), 1e-4)
                for k in METRIC_NAMES)
    print(f"weak-scaling (batch {big}): metric max rel-diff {worst:.2e}")
    for k in METRIC_NAMES:
        a, c = float(m1b[k]), float(mnb[k])
        if not np.isclose(a, c, rtol=2e-3, atol=2e-4):
            print(f"weak-scaling MISMATCH {k}: mesh1={a} mesh{n_devices}={c}")
            ok = False

    if ok:
        print("PARITY-OK")
    return ok


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    sys.exit(0 if run(n) else 1)

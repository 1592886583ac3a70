"""Composed FSDP x TP sharding over a 2-D (data, model) mesh.

New capability (no reference counterpart — the reference is
single-device eager; SURVEY.md §5 "Distributed communication backend").
Composes the two individually-tested strategies on ONE mesh:

- TP (parallel/tp.py rule): every eligible weight's OUTPUT-CHANNEL axis is
  split across the 'model' axis — the computation itself stays
  channel-sharded, so per-device conv FLOPs and activation memory drop with
  the model-parallel factor.
- FSDP (parallel/fsdp.py rule) on what remains: large weights are
  additionally split across the 'data' axis AT REST on their largest
  still-free divisible axis (all-gathered by GSPMD at use, grads
  reduce-scattered back), so per-device parameter + Adam-moment memory drops
  with the data-axis size too. When no second axis divides, the TP axis
  itself is co-sharded by ('model', 'data') if it divides by the product.

This is the standard 2-D layout of the scaling-book recipe (shard weights on
the model axis for compute, then ZeRO the remainder over the data axis for
memory); XLA's SPMD partitioner inserts every collective. Numerics are the
same computation as replicated DP — the parity criterion is tested on the
virtual 8-device CPU mesh as a (4, 2) grid (tests/test_fsdp_tp.py), exactly
like the standalone FSDP and TP tests.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def leaf_fsdp_tp_sharding(mesh: Mesh, shape, tp_min_size: int = 4096,
                          fsdp_min_size: int = 65536) -> NamedSharding:
    """TP rule first (output channel -> 'model'), then FSDP the largest
    remaining divisible axis -> 'data'; falls back to co-sharding the output
    axis by ('model', 'data') when it alone divides the product."""
    mp = mesh.shape.get("model", 1)
    dp = mesh.shape.get("data", 1)
    size = 1
    for d in shape:
        size *= d
    spec = [None] * len(shape)
    # --- TP: output-channel split (mirrors tp.leaf_tp_sharding) ---
    tp_applied = (mp > 1 and size >= tp_min_size and len(shape) >= 2
                  and shape[-1] % mp == 0)
    if tp_applied:
        spec[-1] = "model"
    # --- FSDP: largest still-free divisible axis (mirrors fsdp.leaf_sharding,
    # which prefers the major axis on ties: contiguous re-gathers) ---
    if dp > 1 and size >= fsdp_min_size and shape:
        best_dim, best = None, 0
        for i, d in enumerate(shape):
            if spec[i] is None and d % dp == 0 and d > best:
                best_dim, best = i, d
        if best_dim is not None:
            spec[best_dim] = "data"
        elif tp_applied and shape[-1] % (mp * dp) == 0:
            spec[-1] = ("model", "data")
    if all(s is None for s in spec):  # normalize: replicated == P()
        return NamedSharding(mesh, P())
    return NamedSharding(mesh, P(*spec))


def fsdp_tp_state_shardings(mesh: Mesh, state_shapes, tp_min_size: int = 4096,
                            fsdp_min_size: int = 65536):
    """Map a TrainState eval_shape pytree to composed per-leaf NamedShardings.

    Adam moments (and the EMA tree, when present) mirror their parameter's
    sharding because the rule is applied leaf-by-leaf over the whole
    TrainState shape tree."""
    return jax.tree.map(
        lambda s: leaf_fsdp_tp_sharding(mesh, s.shape, tp_min_size=tp_min_size,
                                        fsdp_min_size=fsdp_min_size),
        state_shapes)

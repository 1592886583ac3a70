"""FSDP/ZeRO-3-style parameter + optimizer-state sharding over the data mesh.

New capability (no reference counterpart — the reference is
single-device eager, SURVEY.md §2 language note). Design per the scaling-book
recipe: annotate each large weight with a NamedSharding that splits its
largest divisible axis across the 'data' mesh axis and let XLA's SPMD
partitioner insert the all-gathers (at use) and reduce-scatters (for grads)
— no hand-written collectives. Numerics are bitwise the same
computation as replicated DP, so the parity criterion is the existing
mesh selftest (`parallel/selftest.py`).

Sharding rule (`param_shardings`): a leaf is split on the largest axis that
is divisible by the mesh size, if the leaf has at least `min_size` elements;
everything else (BN scales, SN power vectors, biases, scalars) stays
replicated — an all-gather of a 64-float vector costs more than it saves.
Optimizer state (Adam mu/nu) mirrors its parameter's sharding automatically
because the TrainState pytree is annotated leaf-by-leaf with the same rule.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def leaf_sharding(mesh: Mesh, shape, min_size: int = 65536,
                  axis: str = "data") -> NamedSharding:
    """NamedSharding splitting the largest mesh-divisible axis, or replicated."""
    n = mesh.shape[axis]
    size = 1
    for d in shape:
        size *= d
    if n > 1 and size >= min_size and shape:
        # largest divisible axis; ties go to the earliest (major) axis, which
        # for conv HWIO kernels and the [vocab, 32, 8192] filter bank is the
        # cheapest to re-gather contiguously
        best_dim, best = None, 0
        for i, d in enumerate(shape):
            if d % n == 0 and d > best:
                best_dim, best = i, d
        if best_dim is not None:
            spec = [None] * len(shape)
            spec[best_dim] = axis
            return NamedSharding(mesh, P(*spec))
    return NamedSharding(mesh, P())


def state_shardings(mesh: Mesh, state_shapes, min_size: int = 65536):
    """Map a TrainState eval_shape pytree to per-leaf NamedShardings.

    The scalar step counter and every optimizer-state leaf follow the same
    rule as the parameters, so Adam moments co-shard with their weights."""
    return jax.tree.map(
        lambda s: leaf_sharding(mesh, s.shape, min_size=min_size), state_shapes)


def shard_state(state, mesh: Mesh, min_size: int = 65536):
    """Device_put an existing (host or replicated) TrainState into FSDP layout."""
    shapes = jax.eval_shape(lambda: state)
    shardings = state_shardings(mesh, shapes, min_size=min_size)
    return jax.device_put(state, shardings)

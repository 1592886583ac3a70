"""Tensor (model) parallelism over a 2-D (data, model) mesh.

New capability (no reference counterpart — the reference is
single-device eager; SURVEY.md §5 "Distributed communication backend").
Design per the scaling-book recipe: weights are annotated with NamedShardings
that split their OUTPUT-CHANNEL axis across the 'model' mesh axis, activations
inherit channel shardings through GSPMD propagation, and XLA inserts the
(all-gather / reduce-scatter / all-reduce) collectives — there are no
hand-written collectives. Where FSDP (parallel/fsdp.py) shards weights *at
rest* and gathers them at use, TP keeps the *computation* channel-sharded, so
per-device activation memory and conv FLOPs drop with the model axis — the
right lever for this model family, whose activations dwarf its weights.

Sharding rule (`leaf_tp_sharding`), by leaf shape:
- rank-4 conv / conv-transpose kernels (kh, kw, cin, cout): split cout
- rank-3 filter bank (vocab, z_dim, 8192): split the 8192 seed axis (it IS
  the seed's channel axis: 8192 = 512*4*4 reshapes to (4, 4, 512) per char)
- rank-2 dense kernels (in, out): split out
- anything below `min_size` elements, indivisible axes, and rank<=1 leaves
  (biases, BN/CBN scales, SN power vectors) stay replicated
Adam moments mirror their parameter's sharding because the rule is applied
leaf-by-leaf over the whole TrainState shape tree.

Numerics are the same computation as the replicated step (GSPMD partitions
it); the parity criterion is tested on the virtual CPU mesh
(tests/test_tp.py), like the DP selftest and FSDP.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def leaf_tp_sharding(mesh: Mesh, shape, min_size: int = 4096,
                     axis: str = "model") -> NamedSharding:
    """NamedSharding splitting the output-channel axis, or replicated."""
    mp = mesh.shape[axis]
    size = 1
    for d in shape:
        size *= d
    if mp > 1 and size >= min_size and len(shape) >= 2:
        out_dim = len(shape) - 1
        if shape[out_dim] % mp == 0:
            spec = [None] * len(shape)
            spec[out_dim] = axis
            return NamedSharding(mesh, P(*spec))
    return NamedSharding(mesh, P())


def tp_state_shardings(mesh: Mesh, state_shapes, min_size: int = 4096):
    """Map a TrainState eval_shape pytree to per-leaf TP NamedShardings."""
    return jax.tree.map(
        lambda s: leaf_tp_sharding(mesh, s.shape, min_size=min_size),
        state_shapes)

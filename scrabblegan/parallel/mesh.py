"""Data parallelism via jax.sharding + jit (SPMD).

A component with NO reference counterpart: the reference runs eagerly on a
single device with no distribution strategy (SURVEY.md §2 language note, §5
"Distributed communication backend"). Design: a 1-D `Mesh('data')` over the
visible devices, parameters + optimizer state replicated (or FSDP/TP-sharded,
see state_sharding_for), batch sharded on its leading axis; XLA's SPMD
partitioner inserts the gradient all-reduces — no hand-written collectives in
the step. The mesh follows the algorithm: on a host whose cards are all joined
to each other (NVLink), any device order is as good as another.

Parity criterion (SURVEY.md §5): numerics identical to the single-device step when
mesh size is 1; a multi-card step matches it to reduction-order rounding.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scrabblegan.config import Config
from scrabblegan.train.state import ModelBundle
from scrabblegan.train.step import make_chunked_train_step, make_train_step


def make_mesh(num_devices: int = -1, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D Mesh('data') — or, with model_parallel > 1, a 2-D
    Mesh(('data', 'model')) of shape (num_devices/mp, mp); P('data') batch
    shardings work unchanged on either mesh."""
    devs = list(devices) if devices is not None else jax.devices()
    if num_devices > 0:
        devs = devs[:num_devices]
    if model_parallel > 1:
        if len(devs) % model_parallel:
            raise ValueError(f"{len(devs)} devices not divisible by "
                             f"model_parallel={model_parallel}")
        return Mesh(np.array(devs).reshape(-1, model_parallel),
                    ("data", "model"))
    return Mesh(np.array(devs), ("data",))


def replicate_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis across the data mesh."""
    return NamedSharding(mesh, P("data"))


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    sh = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), batch)


def state_sharding_for(cfg: Config, mesh: Mesh, state_shapes=None):
    """The TrainState's sharding under this config: replicated (default),
    FSDP (parallel.fsdp — weights split at rest, gathered at use), or TP
    (parallel.model_parallel > 1 — output channels split, computation stays
    sharded). state_shapes (jax.eval_shape of the TrainState) is required for
    the per-leaf modes."""
    tp = getattr(cfg.parallel, "model_parallel", 1) > 1 and "model" in mesh.shape
    fsdp = getattr(cfg.parallel, "fsdp", False) and mesh.shape.get("data", 1) > 1
    if not (tp or fsdp):
        return replicate_sharding(mesh)
    if state_shapes is None:
        raise ValueError("fsdp/tp state sharding requires state_shapes "
                         "(jax.eval_shape of the TrainState)")
    if tp and fsdp:
        # composed 2-D layout: output channels on 'model' (compute sharding),
        # largest remaining axis on 'data' (ZeRO-3 memory sharding)
        from scrabblegan.parallel.fsdp_tp import fsdp_tp_state_shardings

        return fsdp_tp_state_shardings(mesh, state_shapes,
                                       fsdp_min_size=cfg.parallel.fsdp_min_size)
    if tp:
        from scrabblegan.parallel.tp import tp_state_shardings

        return tp_state_shardings(mesh, state_shapes)
    from scrabblegan.parallel.fsdp import state_shardings

    return state_shardings(mesh, state_shapes,
                           min_size=cfg.parallel.fsdp_min_size)


# Process-level memo: the SAME jitted callable for the same (config, models,
# mesh, flags). Two call sites building identical steps (bench.py's raw train
# section and its e2e Trainer; a Trainer restarted in-process) then share one
# XLA compilation through jax's in-memory executable cache, without even a
# persistent-cache lookup. Config/ModelBundle/Mesh hash by value (tested:
# tests/test_step_memo.py).
_STEP_MEMO: dict = {}


def make_parallel_train_step(cfg: Config, models: ModelBundle, mesh: Mesh,
                             donate: bool = True, chunked: bool = False,
                             state_shapes=None):
    """jit the train step over the mesh: batch data-sharded; state replicated,
    or FSDP-sharded when `cfg.parallel.fsdp` (parallel/fsdp.py — params and
    optimizer moments split across the mesh, XLA all-gathers at use).

    Returns a compiled callable step(state, batch, rng) -> (state, metrics).
    chunked=True: batch leaves carry a leading steps_per_call axis and rng is a
    (K, 2) key stack — one dispatch runs K sequential steps (lax.scan); batch
    data stays sharded on its SECOND axis (the per-step batch axis).
    state_shapes: TrainState eval_shape pytree, required for fsdp (per-leaf
    sharding specs). Memoized per process (see _STEP_MEMO note) when
    state_shapes is None — with fsdp/tp the shapes pytree isn't hashable, and
    those flows build the step exactly once anyway."""
    memo_key = None
    if state_shapes is None:
        try:
            # key on the config groups the traced step actually reads
            # (train/step.py: optimizer.*, shared.*, parallel.*) — io.* holds
            # loop-only knobs (paths, ckpt cadence, logging) that must not
            # defeat sharing between e.g. bench.py's raw and e2e sections
            memo_key = (cfg.optimizer, cfg.shared, cfg.parallel,
                        models, mesh, donate, chunked)
            hash(memo_key)
        except TypeError:
            memo_key = None
    if memo_key is not None and memo_key in _STEP_MEMO:
        return _STEP_MEMO[memo_key]
    rep = replicate_sharding(mesh)
    if chunked:
        step = make_chunked_train_step(cfg, models)
        bsh = NamedSharding(mesh, P(None, "data"))
    else:
        step = make_train_step(cfg, models)
        bsh = batch_sharding(mesh)
    ssh = state_sharding_for(cfg, mesh, state_shapes)
    jitted = jax.jit(
        step,
        in_shardings=(ssh, bsh, rep),
        out_shardings=(ssh, rep),
        donate_argnums=(0,) if donate else (),
    )
    if memo_key is not None:
        _STEP_MEMO[memo_key] = jitted
    return jitted

"""Tensor parallelism over the 2-D (data, model) mesh (parallel/tp.py).

Parity criterion (SURVEY.md §5): same numerics as the replicated step — the
weights' output channels are split across the model axis and GSPMD partitions
the computation, inserting the collectives. Runs on the 8-virtual-device CPU
mesh from conftest as a (4, 2) grid."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits 4-network steps

from scrabblegan.config import Config, ParallelConfig, SharedSpecs
from scrabblegan.parallel.tp import leaf_tp_sharding, tp_state_shardings
from scrabblegan.parallel.mesh import (
    make_mesh,
    make_parallel_train_step,
    shard_batch,
)
from scrabblegan.train.state import build_models, create_train_state

B = 8
LEN = 2


def _cfg(mp: int) -> Config:
    return Config(
        shared=dataclasses.replace(SharedSpecs(), batch_size=B),
        parallel=ParallelConfig(model_parallel=mp),
    )


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "real_imgs": rng.uniform(-1, 1, (B, 32, 16 * LEN, 1)).astype(np.float32),
        "real_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
        "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
        "fake_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
    }


class TestLeafTpSharding:
    def test_conv_kernel_splits_out_channels(self):
        mesh = make_mesh(8, model_parallel=2)
        sh = leaf_tp_sharding(mesh, (3, 3, 128, 64))
        assert sh.spec == jax.sharding.PartitionSpec(None, None, None, "model")

    def test_filter_bank_splits_seed_axis(self):
        mesh = make_mesh(8, model_parallel=2)
        sh = leaf_tp_sharding(mesh, (52, 32, 8192))
        assert sh.spec == jax.sharding.PartitionSpec(None, None, "model")

    def test_small_and_indivisible_replicate(self):
        mesh = make_mesh(8, model_parallel=2)
        assert leaf_tp_sharding(mesh, (64,)).spec == jax.sharding.PartitionSpec()
        assert leaf_tp_sharding(mesh, (3, 3, 64, 1),
                                min_size=1).spec == jax.sharding.PartitionSpec()
        assert leaf_tp_sharding(mesh, (32, 256)).spec == (
            jax.sharding.PartitionSpec(None, "model"))


class TestTpStep:
    def test_matches_replicated_numerics_and_actually_shards(self):
        cfg_rep, cfg_tp = _cfg(1), _cfg(2)
        models = build_models(cfg_rep)
        state = create_train_state(cfg_rep, jax.random.PRNGKey(0), models)
        shapes = jax.eval_shape(lambda: state)
        mesh_rep = make_mesh(8)
        mesh_tp = make_mesh(8, model_parallel=2)
        assert dict(mesh_tp.shape) == {"data": 4, "model": 2}
        rng = jax.random.PRNGKey(1)

        step_rep = make_parallel_train_step(cfg_rep, models, mesh_rep,
                                            donate=False)
        step_tp = make_parallel_train_step(cfg_tp, models, mesh_tp,
                                           donate=False, state_shapes=shapes)

        s_rep, m_rep = step_rep(state, shard_batch(_batch(), mesh_rep), rng)
        s_tp, m_tp = step_tp(
            jax.device_put(state, tp_state_shardings(mesh_tp, shapes)),
            shard_batch(_batch(), mesh_tp), rng)

        # the filter bank's seed axis must actually be split 2 ways
        fb = s_tp.g_params["filter_bank"]["filter_bank"]
        shard_shape = fb.sharding.shard_shape(fb.shape)
        assert shard_shape[-1] == fb.shape[-1] // 2

        for name in m_rep:
            np.testing.assert_allclose(
                np.asarray(m_rep[name]), np.asarray(m_tp[name]),
                rtol=2e-3, atol=2e-4, err_msg=name)
        diffs = jax.tree.map(
            lambda a, b: float(jnp.max(jnp.abs(a.astype(jnp.float32)
                                               - b.astype(jnp.float32)))),
            jax.device_get(s_rep.g_params), jax.device_get(s_tp.g_params))
        assert max(jax.tree_util.tree_leaves(diffs)) < 5e-3

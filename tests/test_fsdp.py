"""FSDP/ZeRO-3 parameter + optimizer-state sharding (parallel/fsdp.py).

Parity criterion (SURVEY.md §5): identical numerics to replicated DP — GSPMD
inserts all-gathers/reduce-scatters, the computation is unchanged. Runs on
the 8-virtual-device CPU mesh from conftest."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits 4-network steps

from scrabblegan.config import Config, ParallelConfig, SharedSpecs
from scrabblegan.parallel.fsdp import leaf_sharding, state_shardings
from scrabblegan.parallel.mesh import make_mesh, make_parallel_train_step, shard_batch
from scrabblegan.train.state import build_models, create_train_state

B = 8
LEN = 2


def _cfg(fsdp: bool) -> Config:
    return Config(
        shared=dataclasses.replace(SharedSpecs(), batch_size=B),
        parallel=ParallelConfig(fsdp=fsdp, fsdp_min_size=4096),
    )


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "real_imgs": rng.uniform(-1, 1, (B, 32, 16 * LEN, 1)).astype(np.float32),
        "real_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
        "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
        "fake_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
    }


class TestLeafSharding:
    def test_large_divisible_leaf_splits_largest_axis(self):
        mesh = make_mesh(8)
        sh = leaf_sharding(mesh, (52, 32, 8192), min_size=4096)
        assert sh.spec == jax.sharding.PartitionSpec(None, None, "data")

    def test_small_leaf_replicates(self):
        mesh = make_mesh(8)
        assert leaf_sharding(mesh, (64,), min_size=4096).spec == (
            jax.sharding.PartitionSpec())

    def test_indivisible_leaf_replicates(self):
        mesh = make_mesh(8)
        assert leaf_sharding(mesh, (53, 129), min_size=1).spec == (
            jax.sharding.PartitionSpec())


class TestFsdpStep:
    def test_matches_replicated_numerics_and_actually_shards(self):
        cfg_rep, cfg_fsdp = _cfg(False), _cfg(True)
        models = build_models(cfg_rep)
        state = create_train_state(cfg_rep, jax.random.PRNGKey(0), models)
        shapes = jax.eval_shape(lambda: state)
        mesh = make_mesh(8)
        batch = shard_batch(_batch(), mesh)
        rng = jax.random.PRNGKey(1)

        step_rep = make_parallel_train_step(cfg_rep, models, mesh, donate=False)
        step_fsdp = make_parallel_train_step(cfg_fsdp, models, mesh,
                                             donate=False, state_shapes=shapes)

        s_rep, m_rep = step_rep(state, batch, rng)
        s_fsdp, m_fsdp = step_fsdp(
            jax.device_put(state, state_shardings(mesh, shapes, min_size=4096)),
            batch, rng)

        # the filter bank must actually be split 8 ways on its last axis
        fb = s_fsdp.g_params["filter_bank"]["filter_bank"]
        shard_shape = fb.sharding.shard_shape(fb.shape)
        assert shard_shape[-1] == fb.shape[-1] // 8

        for name in m_rep:
            np.testing.assert_allclose(
                np.asarray(m_rep[name]), np.asarray(m_fsdp[name]),
                rtol=2e-3, atol=2e-4, err_msg=name)
        diffs = jax.tree.map(
            lambda a, b: float(jnp.max(jnp.abs(a.astype(jnp.float32)
                                               - b.astype(jnp.float32)))),
            jax.device_get(s_rep.g_params), jax.device_get(s_fsdp.g_params))
        assert max(jax.tree_util.tree_leaves(diffs)) < 5e-3


class TestEmaSharding:
    def test_g_ema_leaves_co_shard_with_g_params(self):
        """An EMA-enabled state (optimizer.g_ema_decay>0) adds a params-shaped
        g_ema tree; the per-leaf FSDP rule must give each EMA leaf exactly the
        sharding of its parameter twin (eval_shape only — no step compile)."""
        from scrabblegan.config import OptimizerConfig

        cfg = Config(
            optimizer=OptimizerConfig(g_ema_decay=0.999),
            shared=dataclasses.replace(SharedSpecs(), batch_size=B),
            parallel=ParallelConfig(fsdp=True, fsdp_min_size=4096),
        )
        mesh = make_mesh(8)
        shapes = jax.eval_shape(
            lambda: create_train_state(cfg, jax.random.PRNGKey(0)))
        sh = state_shardings(mesh, shapes, min_size=4096)
        assert jax.tree_util.tree_structure(sh.g_ema) == \
            jax.tree_util.tree_structure(sh.g_params)
        for a, b in zip(jax.tree_util.tree_leaves(sh.g_ema),
                        jax.tree_util.tree_leaves(sh.g_params)):
            assert a.spec == b.spec

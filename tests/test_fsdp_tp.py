"""Composed FSDP x TP sharding (parallel/fsdp_tp.py) on the 2-D (data, model)
mesh — VERDICT r2 item 5.

Parity criterion (SURVEY.md §5): same numerics as the replicated step. The
composed layout must ALSO actually shard on both axes: output channels split
across 'model' (TP compute sharding) and a second axis split across 'data'
(ZeRO-3 memory sharding). Runs on the 8-virtual-device CPU mesh as a (4, 2)
grid, mirroring tests/test_tp.py and tests/test_fsdp.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits 4-network steps

from scrabblegan.config import Config, ParallelConfig, SharedSpecs
from scrabblegan.parallel.fsdp_tp import (
    fsdp_tp_state_shardings,
    leaf_fsdp_tp_sharding,
)
from scrabblegan.parallel.mesh import (
    make_mesh,
    make_parallel_train_step,
    shard_batch,
    state_sharding_for,
)
from scrabblegan.train.state import build_models, create_train_state

B = 8
LEN = 2
P = jax.sharding.PartitionSpec


def _cfg(mp: int, fsdp: bool) -> Config:
    return Config(
        shared=dataclasses.replace(SharedSpecs(), batch_size=B),
        parallel=ParallelConfig(model_parallel=mp, fsdp=fsdp),
    )


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "real_imgs": rng.uniform(-1, 1, (B, 32, 16 * LEN, 1)).astype(np.float32),
        "real_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
        "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
        "fake_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
    }


class TestLeafRule:
    def test_conv_kernel_two_axes(self):
        """(3,3,512,1024): cout -> model, cin (largest remaining) -> data."""
        mesh = make_mesh(8, model_parallel=2)
        sh = leaf_fsdp_tp_sharding(mesh, (3, 3, 512, 1024))
        assert sh.spec == P(None, None, "data", "model")

    def test_filter_bank_two_axes(self):
        """(52,32,8192): seed axis -> model; 52 % 4 == 0 -> data on vocab."""
        mesh = make_mesh(8, model_parallel=2)
        sh = leaf_fsdp_tp_sharding(mesh, (52, 32, 8192))
        assert sh.spec == P("data", None, "model")

    def test_fallback_co_shards_output_axis(self):
        """No second divisible axis: the out axis carries both mesh axes."""
        mesh = make_mesh(8, model_parallel=2)
        sh = leaf_fsdp_tp_sharding(mesh, (13, 16384), fsdp_min_size=1024)
        assert sh.spec == P(None, ("model", "data"))

    def test_small_leaves_replicate(self):
        mesh = make_mesh(8, model_parallel=2)
        assert leaf_fsdp_tp_sharding(mesh, (64,)).spec == P()
        # big enough for TP but under the FSDP threshold: model axis only
        sh = leaf_fsdp_tp_sharding(mesh, (32, 256))
        assert sh.spec == P(None, "model")

    def test_mesh_router_selects_composed_rule(self):
        """state_sharding_for must route fsdp+tp to the composed shardings
        (it used to raise 'mutually exclusive')."""
        cfg = _cfg(mp=2, fsdp=True)
        mesh = make_mesh(8, model_parallel=2)
        models = build_models(cfg)
        shapes = jax.eval_shape(
            lambda: create_train_state(cfg, jax.random.PRNGKey(0), models))
        got = state_sharding_for(cfg, mesh, shapes)
        want = fsdp_tp_state_shardings(mesh, shapes)
        assert jax.tree.all(jax.tree.map(lambda a, b: a == b, got, want))


class TestFsdpTpStep:
    def test_matches_replicated_numerics_and_shards_both_axes(self):
        cfg_rep, cfg_2d = _cfg(1, False), _cfg(2, True)
        models = build_models(cfg_rep)
        state = create_train_state(cfg_rep, jax.random.PRNGKey(0), models)
        shapes = jax.eval_shape(lambda: state)
        mesh_rep = make_mesh(8)
        mesh_2d = make_mesh(8, model_parallel=2)
        assert dict(mesh_2d.shape) == {"data": 4, "model": 2}
        rng = jax.random.PRNGKey(1)

        step_rep = make_parallel_train_step(cfg_rep, models, mesh_rep,
                                            donate=False)
        step_2d = make_parallel_train_step(cfg_2d, models, mesh_2d,
                                           donate=False, state_shapes=shapes)

        s_rep, m_rep = step_rep(state, shard_batch(_batch(), mesh_rep), rng)
        s_2d, m_2d = step_2d(
            jax.device_put(state, fsdp_tp_state_shardings(mesh_2d, shapes)),
            shard_batch(_batch(), mesh_2d), rng)

        # the filter bank must be split on BOTH mesh axes: seed axis /2
        # (model) and vocab axis /4 (data) -> each shard holds 1/8
        fb = s_2d.g_params["filter_bank"]["filter_bank"]
        shard_shape = fb.sharding.shard_shape(fb.shape)
        assert shard_shape[-1] == fb.shape[-1] // 2, "model axis inactive"
        assert shard_shape[0] == fb.shape[0] // 4, "data axis inactive"
        # Adam moments co-shard with their parameter (nu: present in both the
        # optax and lean layouts — lean elides mu at the default beta_1=0)
        nu_fb = s_2d.g_opt[0].nu["filter_bank"]["filter_bank"]
        assert nu_fb.sharding.shard_shape(nu_fb.shape) == shard_shape

        for name in m_rep:
            np.testing.assert_allclose(
                np.asarray(m_rep[name]), np.asarray(m_2d[name]),
                rtol=2e-3, atol=2e-4, err_msg=name)
        diffs = jax.tree.map(
            lambda a, b: float(jnp.max(jnp.abs(a.astype(jnp.float32)
                                               - b.astype(jnp.float32)))),
            jax.device_get(s_rep.g_params), jax.device_get(s_2d.g_params))
        assert max(jax.tree_util.tree_leaves(diffs)) < 5e-3

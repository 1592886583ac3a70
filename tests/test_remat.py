"""Rematerialization (jax.checkpoint) option: one step runs and matches the
non-remat step's numerics (remat changes memory, not math)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits multi-network steps / fresh model shapes

from scrabblegan.config import Config, OptimizerConfig, ParallelConfig, SharedSpecs
from scrabblegan.train.state import build_models, create_train_state
from scrabblegan.train.step import make_train_step

B = 4


def _cfg(remat: bool) -> Config:
    return Config(
        optimizer=OptimizerConfig(),
        shared=dataclasses.replace(SharedSpecs(), batch_size=B, remat=remat),
        parallel=ParallelConfig(num_devices=1),
    )


def _batch():
    rng = np.random.default_rng(0)
    return {
        "real_imgs": rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32),
        "real_labels": rng.integers(0, 52, (B, 2)).astype(np.int32),
        "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
        "fake_labels": rng.integers(0, 52, (B, 2)).astype(np.int32),
    }


class TestRemat:
    def test_remat_step_matches_plain(self):
        cfg0, cfg1 = _cfg(False), _cfg(True)
        models = build_models(cfg0)
        state = create_train_state(cfg0, jax.random.PRNGKey(0), models)
        s0, m0 = jax.jit(make_train_step(cfg0, models))(state, _batch(),
                                                        jax.random.PRNGKey(1))
        s1, m1 = jax.jit(make_train_step(cfg1, models))(state, _batch(),
                                                        jax.random.PRNGKey(1))
        for k in m0:
            np.testing.assert_allclose(float(m0[k]), float(m1[k]), rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        leaves0 = jax.tree_util.tree_leaves(s0.g_params)
        leaves1 = jax.tree_util.tree_leaves(s1.g_params)
        for a, b in zip(leaves0, leaves1):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-3,
                                       atol=1e-5)

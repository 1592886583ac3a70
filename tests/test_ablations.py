"""Network-ablation tests (BASELINE.json config 2: G+D adversarial-only
training — no recognizer, no style promoter)."""

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


def _cfg():
    return Config(
        optimizer=OptimizerConfig(),
        shared=dataclasses.replace(
            SharedSpecs(), batch_size=B, z_source="noise",
            use_recognizer=False, use_style_promoter=False),
        parallel=ParallelConfig(num_devices=1),
    )


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "real_imgs": rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32),
        "real_labels": rng.integers(0, 52, (B, 2)).astype(np.int32),
        "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
        "fake_labels": rng.integers(0, 52, (B, 2)).astype(np.int32),
    }


class TestGDOnly:
    @pytest.fixture(scope="class")
    def run(self):
        cfg = _cfg()
        models = build_models(cfg)
        state = create_train_state(cfg, jax.random.PRNGKey(0), models)
        step = jax.jit(make_train_step(cfg, models))
        new_state, metrics = step(state, _batch(), jax.random.PRNGKey(1))
        return state, new_state, metrics

    def test_finite_and_r_w_terms_zero(self, run):
        _, _, m = run
        for k, v in m.items():
            assert np.isfinite(float(v)), k
        for k in ("r_loss_real", "r_loss_fake", "r_loss_balanced",
                  "s_loss", "s_loss_real", "s_loss_fake", "alpha"):
            assert float(m[k]) == 0.0, k
        # G's loss reduces to the pure adversarial term
        np.testing.assert_allclose(float(m["g_loss_final"]), float(m["g_loss"]),
                                   rtol=1e-6)

    def test_g_and_d_update_r_and_w_frozen(self, run):
        state, new_state, _ = run

        def delta(a, b):
            return max(float(x) for x in jax.tree_util.tree_leaves(
                jax.tree.map(lambda u, v: jnp.max(jnp.abs(u - v)), a, b)))

        assert delta(state.g_params, new_state.g_params) > 0
        assert delta(state.d_params, new_state.d_params) > 0
        assert delta(state.r_params, new_state.r_params) == 0.0
        assert delta(state.w_params, new_state.w_params) == 0.0

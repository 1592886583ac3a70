"""bfloat16 compute-policy tests: params stay fp32, outputs/losses fp32-clean,
one full train step finite under shared.dtype=bfloat16."""

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


@pytest.fixture(scope="module")
def bf16_setup():
    cfg = Config(
        optimizer=OptimizerConfig(),
        shared=dataclasses.replace(SharedSpecs(), batch_size=B, dtype="bfloat16"),
        parallel=ParallelConfig(num_devices=1),
    )
    models = build_models(cfg)
    state = create_train_state(cfg, jax.random.PRNGKey(0), models)
    return cfg, models, state


class TestBf16:
    def test_params_are_fp32(self, bf16_setup):
        _, _, state = bf16_setup
        for leaf in jax.tree_util.tree_leaves(state.g_params):
            assert leaf.dtype == jnp.float32

    def test_generator_output_bf16_logits_fp32(self, bf16_setup):
        _, models, state = bf16_setup
        labels = jnp.zeros((B, 2), jnp.int32)
        style = jnp.zeros((B, 32, 160, 1))
        out, _ = models.generator.apply(
            {"params": state.g_params, "batch_stats": state.g_stats},
            labels, style_imgs=style, train=True, mutable=["batch_stats"])
        assert out.dtype == jnp.bfloat16
        logit, _ = models.discriminator.apply(
            {"params": state.d_params, "batch_stats": state.d_stats},
            jnp.zeros((B, 32, 32, 1)), True, mutable=["batch_stats"])
        assert logit.dtype == jnp.float32  # heads cast up for loss stability

    def test_full_step_finite(self, bf16_setup):
        cfg, models, state = bf16_setup
        rng = np.random.default_rng(0)
        batch = {
            "real_imgs": rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32),
            "real_labels": rng.integers(0, 52, (B, 2)).astype(np.int32),
            "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
            "fake_labels": rng.integers(0, 52, (B, 2)).astype(np.int32),
        }
        step = jax.jit(make_train_step(cfg, models))
        new_state, metrics = step(state, batch, jax.random.PRNGKey(1))
        for k, v in metrics.items():
            assert np.isfinite(float(v)), k
        # params remain fp32 after the update
        for leaf in jax.tree_util.tree_leaves(new_state.g_params):
            assert leaf.dtype == jnp.float32


class TestTrunkDtype:
    """shared.trunk_dtype='bfloat16': only the BN-free trunks (D, W, G's
    style encoder) compute in bf16; the CBN/BN up-stack and R stay f32, and
    the param layout is identical to the all-f32 build (checkpoints
    interchangeable)."""

    @pytest.fixture(scope="class")
    def setups(self):
        base = Config(
            shared=dataclasses.replace(SharedSpecs(), batch_size=B),
            parallel=ParallelConfig(num_devices=1),
        )
        tb = dataclasses.replace(
            base, shared=dataclasses.replace(base.shared,
                                             trunk_dtype="bfloat16"))
        m32 = build_models(base)
        mtb = build_models(tb)
        state = create_train_state(base, jax.random.PRNGKey(0), m32)
        return base, tb, m32, mtb, state

    def test_param_tree_identical(self, setups):
        base, tb, m32, mtb, state = setups
        s2 = jax.eval_shape(
            lambda: create_train_state(tb, jax.random.PRNGKey(0), mtb))
        assert (jax.tree_util.tree_structure(state)
                == jax.tree_util.tree_structure(s2))
        for a, b in zip(jax.tree_util.tree_leaves(state),
                        jax.tree_util.tree_leaves(s2)):
            assert a.shape == b.shape and a.dtype == b.dtype

    def test_disc_close_to_f32(self, setups):
        _, _, m32, mtb, state = setups
        rng = np.random.default_rng(1)
        imgs = rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32)
        v = {"params": state.d_params, "batch_stats": state.d_stats}
        a, _ = m32.discriminator.apply(v, imgs, True, mutable=["batch_stats"])
        b, _ = mtb.discriminator.apply(v, imgs, True, mutable=["batch_stats"])
        assert a.dtype == b.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0.05, atol=0.05)

    def test_gen_stays_f32_and_close(self, setups):
        _, _, m32, mtb, state = setups
        labels = jnp.zeros((B, 2), jnp.int32)
        style = jnp.full((B, 32, 160, 1), 0.25, jnp.float32)
        v = {"params": state.g_params, "batch_stats": state.g_stats}
        a, _ = m32.generator.apply(v, labels, style_imgs=style, train=True,
                                   mutable=["batch_stats"])
        b, _ = mtb.generator.apply(v, labels, style_imgs=style, train=True,
                                   mutable=["batch_stats"])
        assert b.dtype == jnp.float32  # up-stack stays f32
        # bf16 z perturbs the whole image path; just bound the drift
        assert float(jnp.mean(jnp.abs(a - b))) < 0.1

    def test_full_step_finite(self, setups):
        _, tb, _, mtb, state = setups
        rng = np.random.default_rng(0)
        batch = {
            "real_imgs": rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32),
            "real_labels": rng.integers(0, 52, (B, 2)).astype(np.int32),
            "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
            "fake_labels": rng.integers(0, 52, (B, 2)).astype(np.int32),
        }
        step = jax.jit(make_train_step(tb, mtb))
        new_state, metrics = step(state, batch, jax.random.PRNGKey(1))
        for k, v in metrics.items():
            assert np.isfinite(float(v)), k


class TestDCGANTrunkBf16:
    """ADVICE r4: the my_disc=1 DCGAN variant's GAP must accumulate in f32
    under a bf16 trunk, mirroring _DownTrunk's rule."""

    def test_close_to_f32_and_head_f32(self):
        from scrabblegan.models import DCGANDiscriminator

        rng = np.random.default_rng(2)
        imgs = rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32)
        d32 = DCGANDiscriminator(dtype=jnp.float32)
        dtb = DCGANDiscriminator(dtype=jnp.bfloat16)
        v = d32.init(jax.random.PRNGKey(0), jnp.zeros((B, 32, 32, 1)), False)
        a = d32.apply(v, imgs, False)
        b = dtb.apply(v, imgs, False)
        assert a.dtype == b.dtype == jnp.float32
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=0.05, atol=0.05)

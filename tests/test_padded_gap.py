"""Padded-vs-narrow objective gap: machinery invariants (VERDICT r3 item 2).

docs/PARITY.md's padded-mode claim is *distributional* (pairing semantics,
tests/test_pairing.py); the per-sample objective differs through three
measured mechanisms — boundary conv/attention halos, BN batch stats over PAD
columns, PAD-seed bleed (scripts/padded_gap_study.py; trained-checkpoint
numbers in docs/quality/padded_gap.json and the PARITY.md paragraph). This
test pins the structural facts that make those numbers trustworthy:

1. ANCHOR EXACTNESS: at L == bucket_size the padded path degenerates to the
   narrow path bit-for-bit (no pad columns, all-ones mask, no PAD labels) —
   the two presentations are the same code path, so every nonzero delta at
   L < bucket_size is attributable to padding, not implementation skew.
2. WHITENING: padded G output beyond 16*len is exactly white (+1).
3. The gap at L < bucket_size is FINITE and BOUNDED at init — a regression
   ceiling so a future change can't silently blow the objective gap up.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scrabblegan.config import Config, IOConfig, SharedSpecs
from scrabblegan.train.state import build_models, create_train_state

B = 4
L_MAX = 3


@pytest.fixture(scope="module")
def setup():
    cfg_p = Config(
        shared=dataclasses.replace(SharedSpecs(), batch_size=B),
        io=dataclasses.replace(IOConfig(), bucket_size=L_MAX),
    )
    cfg_p = dataclasses.replace(
        cfg_p, parallel=dataclasses.replace(cfg_p.parallel,
                                            shape_mode="padded"))
    cfg_n = dataclasses.replace(
        cfg_p, parallel=dataclasses.replace(cfg_p.parallel,
                                            shape_mode="bucketed"))
    models_p = build_models(cfg_p)
    models_n = build_models(cfg_n)
    state = create_train_state(cfg_p, jax.random.PRNGKey(3), models_p)
    # narrow G = padded G minus the filter bank's PAD row
    gp_n = dict(state.g_params)
    gp_n["filter_bank"] = {"filter_bank":
                           state.g_params["filter_bank"]["filter_bank"][:52]}
    return cfg_p, models_p, models_n, state, gp_n


def _imgs(w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (B, 32, w, 1)).astype(np.float32)


def _mask(lengths, w_max):
    cols = jnp.arange(w_max // 8)[None, :]
    return (cols < 2 * jnp.asarray(lengths)[:, None]).astype(jnp.float32)


def _gen(model, variables, labels, style, lengths=None):
    kw = {} if lengths is None else {"lengths": jnp.asarray(lengths)}
    return model.apply(variables, jnp.asarray(labels), style_imgs=style,
                       train=False, **kw)


class TestAnchorExactness:
    """L == bucket_size: padded path == narrow path exactly."""

    def test_discriminator_and_promoter(self, setup):
        cfg, models_p, models_n, state, _ = setup
        imgs = _imgs(16 * L_MAX)
        full_mask = _mask(np.full((B,), L_MAX), 16 * L_MAX)
        for net, params, stats in (
                (models_p.discriminator, state.d_params, state.d_stats),
                (models_p.style_promoter, state.w_params, state.w_stats)):
            v = {"params": params, "batch_stats": stats}
            narrow = net.apply(v, imgs, False)
            padded = net.apply(v, imgs, False, width_mask=full_mask)
            np.testing.assert_allclose(np.asarray(padded), np.asarray(narrow),
                                       atol=1e-5)

    def test_generator(self, setup):
        cfg, models_p, models_n, state, gp_n = setup
        rng = np.random.default_rng(1)
        labels = rng.integers(0, 52, (B, L_MAX)).astype(np.int32)
        style = jnp.asarray(_imgs(160, seed=2))
        out_n = _gen(models_n.generator,
                     {"params": gp_n, "batch_stats": state.g_stats},
                     labels, style)
        out_p = _gen(models_p.generator,
                     {"params": state.g_params, "batch_stats": state.g_stats},
                     labels, style, lengths=np.full((B,), L_MAX))
        np.testing.assert_allclose(np.asarray(out_p), np.asarray(out_n),
                                   atol=1e-6)


class TestPaddedInvariants:
    def test_g_output_white_beyond_content(self, setup):
        cfg, models_p, _, state, _ = setup
        L = 1
        rng = np.random.default_rng(4)
        labels = np.full((B, L_MAX), 52, np.int32)  # PAD id
        labels[:, :L] = rng.integers(0, 52, (B, L))
        style = jnp.asarray(_imgs(160, seed=5))
        out = np.asarray(_gen(
            models_p.generator,
            {"params": state.g_params, "batch_stats": state.g_stats},
            labels, style, lengths=np.full((B,), L)))
        np.testing.assert_array_equal(out[:, :, 16 * L:], 1.0)

    def test_gap_bounded_at_init(self, setup):
        """L=1 of 3 (worst pad fraction): the presentation gap exists but is
        bounded. Ceilings are ~5x the init-time measurement — they catch a
        structural regression (e.g. mask misalignment feeding pad features
        into the GAP denominator), not noise."""
        cfg, models_p, models_n, state, gp_n = setup
        L = 1
        imgs_n = _imgs(16 * L, seed=6)
        imgs_p = np.pad(imgs_n, ((0, 0), (0, 0), (0, 16 * (L_MAX - L)), (0, 0)),
                        constant_values=1.0)
        mask = _mask(np.full((B,), L), 16 * L_MAX)
        v = {"params": state.d_params, "batch_stats": state.d_stats}
        lo_n = np.asarray(models_p.discriminator.apply(v, imgs_n, False))
        lo_p = np.asarray(models_p.discriminator.apply(v, imgs_p, False,
                                                       width_mask=mask))
        assert np.isfinite(lo_p).all()
        # init-time measured max |delta| is ~0.02 absolute (init logits are
        # near-constant so a std-relative bound is meaningless); a structural
        # regression — e.g. a misaligned mask averaging pad features into the
        # GAP — shifts logits by O(1). Ceiling: 10x the measurement.
        assert np.abs(lo_p - lo_n).max() < 0.2, np.abs(lo_p - lo_n).max()

        rng = np.random.default_rng(7)
        labels_n = rng.integers(0, 52, (B, L)).astype(np.int32)
        labels_p = np.pad(labels_n, ((0, 0), (0, L_MAX - L)),
                          constant_values=52)
        style = jnp.asarray(_imgs(160, seed=8))
        out_n = np.asarray(_gen(models_n.generator,
                                {"params": gp_n, "batch_stats": state.g_stats},
                                labels_n, style))
        out_p = np.asarray(_gen(models_p.generator,
                                {"params": state.g_params,
                                 "batch_stats": state.g_stats},
                                labels_p, style, lengths=np.full((B,), L)))
        halo = np.abs(out_p[:, :, :16 * L] - out_n)
        assert np.isfinite(halo).all()
        # tanh-space outputs: the PAD halo must stay well inside the [-1,1]
        # dynamic range on average (trained-checkpoint mean is ~0.006-0.04,
        # docs/quality/padded_gap.json)
        assert halo.mean() < 0.25, halo.mean()

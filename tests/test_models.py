"""Golden shape tests for the G/D/R/W dimension algebra (SURVEY.md §2 "Key
dimension algebra"): 32px height, 16px per character, T = 4*len - 1 CTC frames.

Model inits are shared via module-scoped fixtures (they dominate CPU test time);
since every network is fully convolutional over width, one init serves all widths —
which is itself a property under test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits multi-network steps / fresh model shapes

from scrabblegan.models import (
    BiLSTMRecognizer,
    DCGANDiscriminator,
    Discriminator,
    Generator,
    Recognizer,
    StyleEncoder,
    StylePromoter,
    ctc_time_steps,
    disc_channels,
    gen_channels,
)
from scrabblegan.models.style import StyleExtractor

B = 2
VOCAB = 52
KEY = jax.random.PRNGKey(0)


def _apply(mod, variables, *args, **kwargs):
    out, _ = mod.apply(variables, *args, mutable=["batch_stats"],
                       rngs={"dropout": jax.random.PRNGKey(1)}, **kwargs)
    return out


class TestChannelSchedules:
    def test_gen(self):
        in_ch, out_ch = gen_channels(32)
        assert in_ch == [512, 256, 128]
        assert out_ch == [256, 128, 64]

    def test_disc(self):
        in_ch, out_ch = disc_channels(colors=1, resolution=32)
        assert out_ch == [64, 512, 1024, 1024]
        assert in_ch == [1, 64, 512, 1024]

    def test_unsupported(self):
        with pytest.raises(ValueError):
            gen_channels(64)
        with pytest.raises(ValueError):
            disc_channels(colors=4)


@pytest.fixture(scope="module")
def noise_gen():
    g = Generator(vocab_size=VOCAB, z_source="noise", use_sn=False)
    v = g.init(KEY, jnp.zeros((B, 5), jnp.int32), z=jnp.zeros((B, 128)), train=True)
    return g, v


@pytest.fixture(scope="module")
def style_gen():
    g = Generator(vocab_size=VOCAB, z_source="style", use_sn=False)
    v = g.init(KEY, jnp.zeros((B, 5), jnp.int32),
               style_imgs=jnp.zeros((B, 32, 160, 1)), train=True)
    return g, v


@pytest.fixture(scope="module")
def disc():
    d = Discriminator(use_sn=True)
    v = d.init(KEY, jnp.zeros((B, 32, 160, 1)), True)
    return d, v


class TestGenerator:
    @pytest.mark.parametrize("length", [1, 5, 10])
    def test_width_is_16px_per_char_style(self, style_gen, length):
        g, v = style_gen  # params init'd at L=5 serve every length
        labels = jnp.zeros((B, length), jnp.int32)
        style = jnp.zeros((B, 32, 160, 1))
        out = _apply(g, v, labels, style_imgs=style, train=True)
        assert out.shape == (B, 32, 16 * length, 1)
        assert float(jnp.abs(out).max()) <= 1.0  # tanh range

    def test_noise_source(self, noise_gen):
        g, v = noise_gen
        labels = jnp.zeros((B, 3), jnp.int32)
        z = jax.random.normal(KEY, (B, 128))
        out = _apply(g, v, labels, z=z, train=True)
        assert out.shape == (B, 32, 48, 1)

    def test_seed_layout_concatenates_chars_along_width(self, noise_gen):
        """Two words differing only in their SECOND character must produce
        identical far-left pixels (patch locality of the filter-bank layout)."""
        g, v = noise_gen
        z = jnp.ones((B, 128))
        la = jnp.tile(jnp.array([[0, 1]], jnp.int32), (B, 1))
        lb = jnp.tile(jnp.array([[0, 2]], jnp.int32), (B, 1))
        out_a = g.apply(v, la, z=z, train=False)
        out_b = g.apply(v, lb, z=z, train=False)
        np.testing.assert_allclose(out_a[:, :, :8], out_b[:, :, :8], atol=1e-5)
        assert not np.allclose(out_a[:, :, 16:], out_b[:, :, 16:], atol=1e-3)

    def test_style_encoder_latent(self):
        enc = StyleEncoder(use_sn=False)
        style = jax.random.normal(KEY, (B, 32, 160, 1))
        v = enc.init(KEY, style, True)
        z = _apply(enc, v, style, True)
        assert z.shape == (B, 128)


class TestDiscriminators:
    @pytest.mark.parametrize("width", [16, 80, 160])
    def test_width_agnostic(self, disc, width):
        d, v = disc
        x = jax.random.normal(KEY, (B, 32, width, 1))
        out = _apply(d, v, x, True)
        assert out.shape == (B,)

    def test_dcgan_variant(self):
        d = DCGANDiscriminator(use_sn=False)
        x = jax.random.normal(KEY, (B, 32, 80, 1))
        v = d.init(KEY, x, True)
        out = _apply(d, v, x, True)
        assert out.shape == (B,)

    def test_style_promoter_same_arch_separate_params(self, disc):
        d, vd = disc
        w = StylePromoter(use_sn=True)
        x = jnp.zeros((B, 32, 160, 1))
        vw = w.init(KEY, x, True)
        sd = jax.tree.map(lambda a: a.shape, vd["params"])
        sw = jax.tree.map(lambda a: a.shape, vw["params"])
        assert jax.tree_util.tree_structure(sd) == jax.tree_util.tree_structure(sw)

    def test_masked_gap_padded_mode(self, disc):
        """'padded' shape mode: masked GAP over white padding ~ unpadded GAP."""
        d, v = disc
        x = jax.random.normal(KEY, (B, 32, 80, 1))
        out_plain = d.apply(v, x, False)
        pad = jnp.concatenate([x, jnp.ones((B, 32, 80, 1))], axis=2)
        feat_w = 160 // 8  # three down-pools
        mask = (jnp.arange(feat_w)[None, :] < 80 // 8).astype(jnp.float32)
        mask = jnp.broadcast_to(mask, (B, feat_w))
        out_masked = d.apply(v, pad, False, width_mask=mask)
        # edge receptive-field bleed at the seam allows small deviation
        np.testing.assert_allclose(out_plain, out_masked, rtol=0.15, atol=0.2)


class TestRecognizers:
    @pytest.mark.parametrize("length", [2, 10])
    def test_ctc_frames_algebra(self, length):
        r = Recognizer(num_classes=53)
        x = jnp.zeros((B, 32, 16 * length, 1))
        if length == 2:
            self.__class__._rec_vars = r.init({"params": KEY, "dropout": KEY}, x, True)
        logits = _apply(r, self.__class__._rec_vars, x, True)
        assert logits.shape == (B, 4 * length - 1, 53)
        assert ctc_time_steps(16 * length) == 4 * length - 1

    def test_bilstm_variant(self):
        r = BiLSTMRecognizer(num_classes=53)
        x = jnp.zeros((B, 32, 64, 1))  # 4-char word
        v = r.init({"params": KEY, "dropout": KEY}, x, True)
        logits = _apply(r, v, x, True)
        assert logits.shape == (B, 16, 53)  # T = W/4, no final valid conv
        assert ctc_time_steps(64, my_rec=True) == 16


class TestStyleExtractor:
    def test_embedding_head(self):
        m = StyleExtractor(use_sn=False)
        x = jnp.zeros((B, 32, 160, 1))
        v = m.init(KEY, x, True)
        out = _apply(m, v, x, True)
        assert out.shape == (B, 128)

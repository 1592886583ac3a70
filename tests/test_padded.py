"""'padded' shape-mode tests: single static shape with width masks, pad-token
filter bank, white-masked generator output, masked D/W pooling, CTC lengths."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits multi-network steps / fresh model shapes

from scrabblegan.config import Config, OptimizerConfig, ParallelConfig, SharedSpecs
from scrabblegan.models import Generator
from scrabblegan.train.state import build_models, create_train_state
from scrabblegan.train.step import METRIC_NAMES, make_train_step

B = 8
L_MAX = 4
KEY = jax.random.PRNGKey(0)


def padded_cfg():
    return Config(
        optimizer=OptimizerConfig(),
        shared=dataclasses.replace(SharedSpecs(), batch_size=B),
        io=dataclasses.replace(Config().io, bucket_size=L_MAX),
        parallel=ParallelConfig(num_devices=1, shape_mode="padded"),
    )


class TestPaddedGenerator:
    def test_pad_token_and_width_mask(self):
        g = Generator(vocab_size=52, z_source="noise", use_sn=False,
                      num_pad_tokens=1)
        labels = jnp.array([[0, 1, 52, 52]] * B, jnp.int32)  # true len 2, pad id 52
        lengths = jnp.full((B,), 2, jnp.int32)
        z = jax.random.normal(KEY, (B, 128))
        v = g.init(KEY, labels, z=z, lengths=lengths, train=False)
        bank = v["params"]["filter_bank"]["filter_bank"]
        assert bank.shape[0] == 53  # 52 chars + PAD row
        out = g.apply(v, labels, z=z, lengths=lengths, train=False)
        assert out.shape == (B, 32, 16 * L_MAX, 1)
        # beyond 16*len columns the canvas must be exactly white (+1)
        np.testing.assert_allclose(np.asarray(out[:, :, 32:]), 1.0)
        assert float(jnp.abs(out[:, :, :32]).max()) <= 1.0
        assert not np.allclose(np.asarray(out[:, :, :32]), 1.0)


class TestPaddedStep:
    @pytest.fixture(scope="class")
    def setup(self):
        cfg = padded_cfg()
        models = build_models(cfg)
        state = create_train_state(cfg, KEY, models)
        step = jax.jit(make_train_step(cfg, models))
        return cfg, models, state, step

    def make_batch(self, real_len=2, fake_len=3, seed=0):
        rng = np.random.default_rng(seed)
        w_max = 16 * L_MAX
        real = np.full((B, 32, w_max, 1), 1.0, np.float32)
        real[:, :, :16 * real_len] = rng.uniform(-1, 1, (B, 32, 16 * real_len, 1))
        real_labels = np.full((B, L_MAX), 52, np.int32)
        real_labels[:, :real_len] = rng.integers(0, 52, (B, real_len))
        fake_labels = np.full((B, L_MAX), 52, np.int32)
        fake_labels[:, :fake_len] = rng.integers(0, 52, (B, fake_len))
        return {
            "real_imgs": real,
            "real_labels": real_labels,
            "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
            "fake_labels": fake_labels,
            "real_lengths": np.full((B,), real_len, np.int32),
            "fake_lengths": np.full((B,), fake_len, np.int32),
        }

    def test_step_runs_and_finite(self, setup):
        _, _, state, step = setup
        new_state, metrics = step(state, self.make_batch(), KEY)
        assert set(metrics) == set(METRIC_NAMES)
        for k, v in metrics.items():
            assert np.isfinite(float(v)), k
        assert int(new_state.step) == 1

    def test_one_compilation_for_all_lengths(self, setup):
        """The whole point of padded mode: different word lengths hit the SAME
        compiled executable (static shapes are identical)."""
        _, _, state, step = setup
        step(state, self.make_batch(real_len=2, fake_len=3), KEY)
        compiled_before = step._cache_size()
        step(state, self.make_batch(real_len=4, fake_len=1, seed=1), KEY)
        assert step._cache_size() == compiled_before == 1

    def test_mixed_lengths_within_batch(self, setup):
        """batch_mix='sample': per-SAMPLE length vectors (each row its own
        word length) run through the same compiled step — the masks and CTC
        lengths are per-sample, so a mixed-width batch is just data."""
        _, _, state, step = setup
        rng = np.random.default_rng(5)
        real_lens = rng.integers(1, L_MAX + 1, size=B)
        fake_lens = rng.integers(1, L_MAX + 1, size=B)
        assert len(np.unique(real_lens)) > 1  # genuinely mixed
        w_max = 16 * L_MAX
        real = np.full((B, 32, w_max, 1), 1.0, np.float32)
        real_labels = np.full((B, L_MAX), 52, np.int32)
        fake_labels = np.full((B, L_MAX), 52, np.int32)
        for i in range(B):
            rl, fl = int(real_lens[i]), int(fake_lens[i])
            real[i, :, :16 * rl] = rng.uniform(-1, 1, (32, 16 * rl, 1))
            real_labels[i, :rl] = rng.integers(0, 52, rl)
            fake_labels[i, :fl] = rng.integers(0, 52, fl)
        batch = {
            "real_imgs": real,
            "real_labels": real_labels,
            "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
            "fake_labels": fake_labels,
            "real_lengths": real_lens.astype(np.int32),
            "fake_lengths": fake_lens.astype(np.int32),
        }
        compiled_before = step._cache_size()
        new_state, metrics = step(state, batch, KEY)
        assert step._cache_size() == compiled_before  # no new specialization
        for k, v in metrics.items():
            assert np.isfinite(float(v)), k

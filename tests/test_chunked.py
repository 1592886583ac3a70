"""Chunked multi-step dispatch tests: a K-step scan call must equal K sequential
single-step calls bit-for-bit (same batches, same rngs)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits multi-network steps / fresh model shapes

from scrabblegan.config import Config, OptimizerConfig, ParallelConfig, SharedSpecs
from scrabblegan.train.state import build_models, create_train_state
from scrabblegan.train.step import make_chunked_train_step, make_train_step

B, K, LEN = 4, 3, 2


def _cfg():
    return Config(
        optimizer=OptimizerConfig(),
        shared=dataclasses.replace(SharedSpecs(), batch_size=B, z_source="noise"),
        parallel=ParallelConfig(num_devices=1, steps_per_call=K),
    )


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    return [{
        "real_imgs": rng.uniform(-1, 1, (B, 32, 16 * LEN, 1)).astype(np.float32),
        "real_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
        "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
        "fake_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
    } for _ in range(K)]


class TestChunkedStep:
    def test_chunk_equals_sequential(self):
        cfg = _cfg()
        models = build_models(cfg)
        state0 = create_train_state(cfg, jax.random.PRNGKey(0), models)
        batches = _batches()
        rngs = jax.random.split(jax.random.PRNGKey(7), K)

        step = jax.jit(make_train_step(cfg, models))
        s_seq = state0
        seq_metrics = []
        for i in range(K):
            s_seq, m = step(s_seq, batches[i], rngs[i])
            seq_metrics.append(jax.device_get(m))

        chunk = jax.jit(make_chunked_train_step(cfg, models))
        stacked = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
        s_chk, m_chk = chunk(state0, stacked, rngs)
        m_chk = jax.device_get(m_chk)

        assert int(s_chk.step) == int(s_seq.step) == K
        # XLA fuses the scanned body differently from the standalone step, so
        # float reassociation drifts ~1e-4 relative by the 2nd-3rd step (the
        # GAN feedback loop amplifies ulp differences); semantic equivalence,
        # not bit equality, is the contract.
        for i in range(K):
            for key in seq_metrics[i]:
                np.testing.assert_allclose(
                    float(m_chk[key][i]), float(seq_metrics[i][key]),
                    rtol=5e-3, atol=1e-4, err_msg=f"step {i} {key}")
        for a, b in zip(jax.tree_util.tree_leaves(s_seq.g_params),
                        jax.tree_util.tree_leaves(s_chk.g_params)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=5e-3,
                                       atol=5e-3)

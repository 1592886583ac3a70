"""Generator weight EMA (optimizer.g_ema_decay — BigGAN arXiv:1809.11096 §3,
absent from the reference). Covers: exact lerp trajectory vs a hand
computation, cadence coupling (EMA frozen on G-skip steps), default-off state
shape (g_ema is None so round-1 checkpoints restore unchanged), and the
export/grid paths serving the EMA weights."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits multi-network steps

from scrabblegan.config import Config, OptimizerConfig, ParallelConfig, SharedSpecs
from scrabblegan.train.state import build_models, create_train_state
from scrabblegan.train.step import make_train_step

B = 8
LEN = 2
DECAY = 0.5  # large (1-d) so one step moves the EMA measurably


def _cfg(**opt_kwargs) -> Config:
    return Config(
        optimizer=OptimizerConfig(g_ema_decay=DECAY, **opt_kwargs),
        shared=dataclasses.replace(SharedSpecs(), batch_size=B),
        parallel=ParallelConfig(num_devices=1),
    )


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "real_imgs": rng.uniform(-1, 1, (B, 32, 16 * LEN, 1)).astype(np.float32),
        "real_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
        "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
        "fake_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def ema_setup():
    cfg = _cfg()
    models = build_models(cfg)
    state = create_train_state(cfg, jax.random.PRNGKey(0), models)
    step = jax.jit(make_train_step(cfg, models))
    return cfg, models, state, step


def _max_abs_diff(a, b):
    leaves = jax.tree_util.tree_leaves(
        jax.tree.map(lambda x, y: jnp.max(jnp.abs(x - y)), a, b))
    return max(float(x) for x in leaves)


def test_default_off_keeps_round1_state_shape():
    cfg = Config(shared=dataclasses.replace(SharedSpecs(), batch_size=B),
                 parallel=ParallelConfig(num_devices=1))
    state = create_train_state(cfg, jax.random.PRNGKey(0))
    assert state.g_ema is None
    # None is an empty pytree: the leaf set matches a pre-EMA TrainState, so
    # old full-state checkpoints restore into this template unchanged
    assert not jax.tree_util.tree_leaves(state.g_ema)


def test_ema_initialized_to_init_weights(ema_setup):
    _, _, state, _ = ema_setup
    assert state.g_ema is not None
    assert _max_abs_diff(state.g_ema, state.g_params) == 0.0


def test_ema_follows_exact_lerp(ema_setup):
    """After each G update: ema = d*ema + (1-d)*params, computed by hand from
    the observed param trajectory."""
    _, _, state, step = ema_setup
    s1, _ = step(state, _batch(1), jax.random.PRNGKey(1))
    want1 = jax.tree.map(lambda e, p: DECAY * e + (1 - DECAY) * p,
                         state.g_ema, s1.g_params)
    assert _max_abs_diff(s1.g_ema, want1) < 1e-6
    s2, _ = step(s1, _batch(2), jax.random.PRNGKey(2))
    want2 = jax.tree.map(lambda e, p: DECAY * e + (1 - DECAY) * p,
                         want1, s2.g_params)
    assert _max_abs_diff(s2.g_ema, want2) < 1e-6
    # and the EMA is genuinely distinct from the live weights
    assert _max_abs_diff(s2.g_ema, s2.g_params) > 0


def test_ema_frozen_on_g_skip_steps():
    """disc_iters=2: step 1 skips the G update, so the EMA must not move
    either; step 2 updates both."""
    cfg = _cfg(disc_iters=2)
    models = build_models(cfg)
    state = create_train_state(cfg, jax.random.PRNGKey(0), models)
    step = jax.jit(make_train_step(cfg, models))
    s1, _ = step(state, _batch(1), jax.random.PRNGKey(1))
    assert _max_abs_diff(s1.g_ema, state.g_ema) == 0.0
    assert _max_abs_diff(s1.g_params, state.g_params) == 0.0
    s2, _ = step(s1, _batch(2), jax.random.PRNGKey(2))
    assert _max_abs_diff(s2.g_ema, state.g_ema) > 0


def test_export_and_grid_serve_ema(tmp_path, ema_setup):
    """Trainer.generate and the per-epoch export must read g_ema, not the
    live params, when EMA is on."""
    from scrabblegan.train import checkpoint as ckpt_lib
    from scrabblegan.train.loop import Trainer

    cfg, models, state, step = ema_setup
    s1, _ = step(state, _batch(1), jax.random.PRNGKey(1))
    # poison the live params: if generate/export used them, outputs change
    poisoned = s1.replace(g_params=jax.tree.map(lambda x: x + 100.0, s1.g_params))

    trainer = Trainer(cfg, workdir=str(tmp_path), verbose=False)
    labels = np.zeros((2, LEN), np.int32)
    style = np.zeros((2, 32, 160, 1), np.float32)
    out_ema = np.asarray(trainer.generate(s1, labels, style))
    out_poisoned = np.asarray(trainer.generate(poisoned, labels, style))
    np.testing.assert_array_equal(out_ema, out_poisoned)

    trainer.seed_labels = labels
    trainer.seed_style = style
    trainer.save_epoch_artifacts(poisoned, epoch=1, final=False)
    exported = ckpt_lib.load_generator(
        ckpt_lib.latest_generator_export(trainer.model_path))
    got = jax.tree_util.tree_leaves(exported["params"])
    want = jax.tree_util.tree_leaves(jax.device_get(s1.g_ema))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=0)


class TestStandingStats:
    @pytest.fixture(scope="class")
    def trained_ema(self, tmp_path_factory):
        """A real (tiny) EMA run on the synthetic fixture — standing stats
        need the Trainer's data-driven batch maker."""
        from scrabblegan.config import IOConfig
        from scrabblegan.data.synthetic import make_synthetic_dataset
        from scrabblegan.train.loop import Trainer

        cfg = Config(
            optimizer=OptimizerConfig(g_ema_decay=DECAY,
                                      ema_standing_stat_batches=2),
            shared=dataclasses.replace(SharedSpecs(), batch_size=4, num_gen=4),
            io=dataclasses.replace(IOConfig(), bucket_size=3),
            parallel=ParallelConfig(num_devices=1),
        )
        data_root = str(tmp_path_factory.mktemp("data"))
        read_dir, words_file, style_dir = make_synthetic_dataset(
            data_root, samples_per_bucket=4, bucket_size=3)
        trainer = Trainer(cfg, workdir=str(tmp_path_factory.mktemp("run")),
                          verbose=False)
        trainer.load_data(read_dir=read_dir, style_dir=style_dir,
                          words_file=words_file)
        state = trainer.train(epochs=1, batches_per_epoch=2, resume=False)
        return trainer, state

    def test_standing_stats_differ_from_live(self, trained_ema):
        trainer, state = trained_ema
        stand = trainer.standing_stats(state, n_batches=2)
        assert stand is not None
        assert _max_abs_diff(jax.device_get(stand),
                             jax.device_get(state.g_stats)) > 0

    def test_export_carries_standing_stats(self, trained_ema):
        """The per-epoch export's batch_stats must be the standing-stats
        refresh, not the live running stats."""
        from scrabblegan.train import checkpoint as ckpt_lib

        trainer, state = trained_ema
        export = ckpt_lib.load_generator(
            ckpt_lib.latest_generator_export(trainer.model_path))
        live = jax.device_get(state.g_stats)
        assert _max_abs_diff(export["batch_stats"], live) > 0

    def test_zero_batches_disables(self, trained_ema):
        trainer, state = trained_ema
        assert trainer.standing_stats(state, n_batches=0) is None

"""Lean Adam (train/optim.py): exact-math parity with optax.adam, the b1==0
first-moment elision, and the bf16 moment storage tolerance.

The train step's optimizer tail is a pure HBM-traffic cost (docs/PARITY.md);
these tests pin that the traffic cut does not change the math.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from scrabblegan.train.optim import ScaleByLeanAdamState, lean_adam


def _tree(seed=0):
    k = jax.random.split(jax.random.PRNGKey(seed), 3)
    return {
        "w": jax.random.normal(k[0], (16, 8), jnp.float32),
        "b": jax.random.normal(k[1], (8,), jnp.float32),
        "deep": {"k": jax.random.normal(k[2], (3, 3, 4, 4), jnp.float32)},
    }


def _run(opt, params, n_steps=5, seed=42):
    state = opt.init(params)
    traj = []
    for i in range(n_steps):
        grads = jax.tree.map(
            lambda p: jax.random.normal(jax.random.PRNGKey(seed + i), p.shape),
            params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        traj.append(params)
    return params, state, traj


@pytest.mark.parametrize("b1", [0.0, 0.5])
def test_lean_matches_optax_f32(b1):
    """moment_dtype=float32: the lean update IS adam — same trajectory to
    float roundoff, including the reference's b1=0 (mu-elided) case."""
    params = _tree()
    ref, _, ref_traj = _run(optax.adam(2e-4, b1=b1, b2=0.999), params)
    got, _, got_traj = _run(lean_adam(2e-4, b1=b1, b2=0.999), params)
    for r, g in zip(jax.tree.leaves(ref_traj[-1]), jax.tree.leaves(got_traj[-1])):
        np.testing.assert_allclose(np.asarray(r), np.asarray(g),
                                   rtol=1e-6, atol=1e-8)


def test_mu_elided_at_b1_zero():
    """b1 == 0 (the reference default, scrabble_gan.gin:6): no first-moment
    buffer exists in the state — 8 B/param of update traffic gone."""
    params = _tree()
    opt = lean_adam(2e-4, b1=0.0, b2=0.999)
    state = opt.init(params)
    inner = state[0]
    assert isinstance(inner, ScaleByLeanAdamState)
    assert inner.mu is None
    # leaf count: nu tree only (+ the count scalar), vs optax's mu + nu
    lean_leaves = len(jax.tree.leaves(state))
    optax_leaves = len(jax.tree.leaves(optax.adam(2e-4, b1=0.0).init(params)))
    n_params = len(jax.tree.leaves(params))
    assert lean_leaves == optax_leaves - n_params


def test_mu_kept_at_nonzero_b1():
    params = _tree()
    state = lean_adam(2e-4, b1=0.5, b2=0.999).init(params)
    assert state[0].mu is not None


def test_bf16_moments_dtype_and_tolerance():
    """moment_dtype=bfloat16: state is stored bf16; the trajectory tracks the
    f32 one to ~bf16 resolution (the math runs in f32, only storage rounds)."""
    params = _tree()
    opt = lean_adam(2e-4, b1=0.0, b2=0.999, moment_dtype="bfloat16")
    state = opt.init(params)
    for leaf in jax.tree.leaves(state[0].nu):
        assert leaf.dtype == jnp.bfloat16
    ref, _, _ = _run(optax.adam(2e-4, b1=0.0, b2=0.999), params, n_steps=10)
    got, final_state, _ = _run(opt, params, n_steps=10)
    for leaf in jax.tree.leaves(final_state[0].nu):
        assert leaf.dtype == jnp.bfloat16
    for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        r, g = np.asarray(r), np.asarray(g)
        # update magnitudes are ~lr; bf16 nu perturbs step SIZES by ~0.4%
        np.testing.assert_allclose(r, g, rtol=0, atol=2e-2 * 2e-4 * 10)


def test_make_optimizers_lean_wiring():
    """config plumbing: adam_impl='lean' + moment_dtype reach all four nets
    (R keeps rmsprop when asked); unknown impl raises."""
    from scrabblegan.config import Config, OptimizerConfig
    from scrabblegan.train.state import make_optimizers

    cfg = Config(optimizer=OptimizerConfig(adam_impl="lean",
                                           moment_dtype="bfloat16"))
    opts = make_optimizers(cfg)
    params = _tree()
    for name in ("g", "d", "r", "w"):
        st = opts[name].init(params)
        assert st[0].mu is None  # beta_1 default 0.0
        assert all(l.dtype == jnp.bfloat16 for l in jax.tree.leaves(st[0].nu))
    with pytest.raises(ValueError, match="adam_impl"):
        make_optimizers(Config(optimizer=OptimizerConfig(adam_impl="nope")))
    cfg_r = Config(optimizer=OptimizerConfig(adam_impl="lean", rmsprop=True))
    st_r = make_optimizers(cfg_r)["r"].init(params)
    assert not isinstance(st_r[0], ScaleByLeanAdamState)  # rmsprop untouched


@pytest.mark.slow  # two full 4-network step compiles
def test_lean_step_parity_full():
    """The real train step under adam_impl='lean' (f32, b1=0) produces the
    same post-step parameters as stock optax — the mu elision is exact math,
    end to end through all four networks."""
    from scrabblegan.config import (Config, OptimizerConfig,
                                        ParallelConfig, SharedSpecs)
    from scrabblegan.train.state import build_models, create_train_state
    from scrabblegan.train.step import make_train_step

    B, LEN = 8, 2
    rng = np.random.default_rng(0)
    batch = {
        "real_imgs": rng.uniform(-1, 1, (B, 32, 16 * LEN, 1)).astype(np.float32),
        "real_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
        "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
        "fake_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
    }

    def run(**opt_kwargs):
        cfg = Config(optimizer=OptimizerConfig(**opt_kwargs),
                     shared=dataclasses.replace(SharedSpecs(), batch_size=B),
                     parallel=ParallelConfig(num_devices=1))
        models = build_models(cfg)
        state = create_train_state(cfg, jax.random.PRNGKey(0), models)
        step = jax.jit(make_train_step(cfg, models))
        new_state, metrics = step(state, batch, jax.random.PRNGKey(1))
        return new_state, metrics

    ref_state, ref_m = run()
    lean_state, lean_m = run(adam_impl="lean")
    np.testing.assert_allclose(float(ref_m["d_loss"]),
                               float(lean_m["d_loss"]), rtol=1e-6)
    for name in ("g_params", "d_params", "r_params", "w_params"):
        for r, g in zip(jax.tree.leaves(getattr(ref_state, name)),
                        jax.tree.leaves(getattr(lean_state, name))):
            np.testing.assert_allclose(np.asarray(r), np.asarray(g),
                                       rtol=2e-5, atol=1e-7)


def test_lean_with_schedule():
    """lr schedules chain through the lean transform like through optax.adam."""
    from scrabblegan.config import Config, OptimizerConfig
    from scrabblegan.train.state import make_optimizers

    params = _tree()
    base = dict(adam_impl="lean", lr_schedule="cosine", decay_steps=100)
    cfg = Config(optimizer=OptimizerConfig(**base))
    ref_cfg = Config(optimizer=OptimizerConfig(lr_schedule="cosine",
                                               decay_steps=100))
    got, _, _ = _run(make_optimizers(cfg)["g"], params)
    ref, _, _ = _run(make_optimizers(ref_cfg)["g"], params)
    for r, g in zip(jax.tree.leaves(ref), jax.tree.leaves(got)):
        np.testing.assert_allclose(np.asarray(r), np.asarray(g),
                                   rtol=1e-6, atol=1e-8)

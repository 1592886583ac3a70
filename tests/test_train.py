"""Single-step training tests (SURVEY.md §4 plan: finite losses, correct gradient
routing between the four networks, disc_iters cadence, mesh=1 vs mesh=8 parity)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits multi-network steps / fresh model shapes

from scrabblegan.config import Config, OptimizerConfig, ParallelConfig, SharedSpecs
from scrabblegan.parallel.mesh import make_mesh, make_parallel_train_step
from scrabblegan.train.state import build_models, create_train_state
from scrabblegan.train.step import METRIC_NAMES, make_train_step

B = 8
LEN = 2


def tiny_cfg(**opt_kwargs) -> Config:
    return Config(
        optimizer=OptimizerConfig(**opt_kwargs),
        shared=dataclasses.replace(SharedSpecs(), batch_size=B),
        parallel=ParallelConfig(num_devices=1),
    )


def make_batch(seed=0, fake_seed=1):
    rng = np.random.default_rng(seed)
    frng = np.random.default_rng(fake_seed)
    return {
        "real_imgs": rng.uniform(-1, 1, (B, 32, 16 * LEN, 1)).astype(np.float32),
        "real_labels": rng.integers(0, 52, (B, LEN)).astype(np.int32),
        "style_imgs": rng.uniform(-1, 1, (B, 32, 160, 1)).astype(np.float32),
        "fake_labels": frng.integers(0, 52, (B, LEN)).astype(np.int32),
    }


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_cfg()
    models = build_models(cfg)
    state = create_train_state(cfg, jax.random.PRNGKey(0), models)
    step = jax.jit(make_train_step(cfg, models))
    return cfg, models, state, step


def _delta(tree_a, tree_b):
    """Max abs param change between two pytrees."""
    leaves = jax.tree_util.tree_leaves(
        jax.tree.map(lambda a, b: jnp.max(jnp.abs(a - b)), tree_a, tree_b))
    return max(float(x) for x in leaves)


class TestSingleStep:
    def test_metrics_finite_and_complete(self, setup):
        _, _, state, step = setup
        new_state, metrics = step(state, make_batch(), jax.random.PRNGKey(2))
        assert set(metrics) == set(METRIC_NAMES)
        for k, v in metrics.items():
            assert np.isfinite(float(v)), f"{k} not finite"
        assert int(new_state.step) == 1

    def test_all_networks_update(self, setup):
        _, _, state, step = setup
        new_state, _ = step(state, make_batch(), jax.random.PRNGKey(2))
        assert _delta(state.g_params, new_state.g_params) > 0
        assert _delta(state.d_params, new_state.d_params) > 0
        assert _delta(state.r_params, new_state.r_params) > 0
        assert _delta(state.w_params, new_state.w_params) > 0

    def test_recognizer_trains_on_real_only(self, setup):
        """Changing ONLY the fake labels must not change R's update (the CTC-on-fake
        term steers G alone — reference data_utils.py:454, SURVEY.md defect #5)."""
        _, _, state, step = setup
        s1, _ = step(state, make_batch(fake_seed=1), jax.random.PRNGKey(2))
        s2, _ = step(state, make_batch(fake_seed=7), jax.random.PRNGKey(2))
        assert _delta(s1.r_params, s2.r_params) < 1e-7
        # while G (fed by fake labels) and D (sees different gen images) DO differ
        assert _delta(s1.g_params, s2.g_params) > 0
        assert _delta(s1.d_params, s2.d_params) > 0

    def test_changing_real_labels_does_not_change_g_or_w(self, setup):
        """Real labels only enter the R-on-real CTC term; G/W updates must be
        untouched by them."""
        _, _, state, step = setup
        b1 = make_batch()
        b2 = dict(b1)
        b2["real_labels"] = (b1["real_labels"] + 1) % 52
        s1, _ = step(state, b1, jax.random.PRNGKey(2))
        s2, _ = step(state, b2, jax.random.PRNGKey(2))
        assert _delta(s1.g_params, s2.g_params) < 1e-7
        assert _delta(s1.w_params, s2.w_params) < 1e-7
        assert _delta(s1.r_params, s2.r_params) > 0


class TestDiscIters:
    def test_g_update_cadence(self):
        """disc_iters=2: G must NOT update on step 1, must update on step 2
        (reference data_utils.py:462)."""
        cfg = tiny_cfg(disc_iters=2)
        models = build_models(cfg)
        state = create_train_state(cfg, jax.random.PRNGKey(0), models)
        step = jax.jit(make_train_step(cfg, models))
        s1, _ = step(state, make_batch(), jax.random.PRNGKey(2))
        assert _delta(state.g_params, s1.g_params) == 0.0
        assert _delta(state.d_params, s1.d_params) > 0
        s2, _ = step(s1, make_batch(seed=3), jax.random.PRNGKey(3))
        assert _delta(s1.g_params, s2.g_params) > 0


class TestGradientBalance:
    def test_balanced_vs_added(self, setup):
        cfg_b = tiny_cfg(apply_gradient_balance=True)
        models = build_models(cfg_b)
        state = create_train_state(cfg_b, jax.random.PRNGKey(0), models)
        step_b = jax.jit(make_train_step(cfg_b, models))
        _, m = step_b(state, make_batch(), jax.random.PRNGKey(2))
        # g_loss_final must equal the balanced term when balancing is on
        np.testing.assert_allclose(float(m["g_loss_final"]),
                                   float(m["g_loss_balanced"]), rtol=1e-6)
        _, m2 = setup[3](setup[2], make_batch(), jax.random.PRNGKey(2))
        np.testing.assert_allclose(float(m2["g_loss_final"]),
                                   float(m2["g_loss_added"]), rtol=1e-6)

    def test_grad_norm_mode_routes_only_g(self):
        """balance_mode='grad_norm' rescales G's image-cotangents in the
        backward only: metrics and D/R/W updates match loss_rescale-off
        exactly (the fanout is identity forward; their grads never cross it),
        while G's update differs."""
        models = build_models(tiny_cfg())
        state = create_train_state(tiny_cfg(), jax.random.PRNGKey(0), models)
        batch, key = make_batch(), jax.random.PRNGKey(2)
        s_plain, m_plain = jax.jit(make_train_step(
            tiny_cfg(), models))(state, batch, key)
        s_gn, m_gn = jax.jit(make_train_step(
            tiny_cfg(apply_gradient_balance=True, balance_mode="grad_norm"),
            models))(state, batch, key)
        # value path: plain sum in both
        np.testing.assert_allclose(float(m_gn["g_loss_final"]),
                                   float(m_plain["g_loss_added"]), rtol=1e-5)
        for k in ("d_loss", "r_loss_real", "s_loss"):
            np.testing.assert_allclose(float(m_gn[k]), float(m_plain[k]),
                                       rtol=1e-6)
        # D/R/W gradients don't cross the fanout
        assert _delta(s_gn.d_params, s_plain.d_params) < 1e-7
        assert _delta(s_gn.r_params, s_plain.r_params) < 1e-7
        assert _delta(s_gn.w_params, s_plain.w_params) < 1e-7
        # G's gradient is rescaled
        assert _delta(s_gn.g_params, s_plain.g_params) > 1e-7
        for k, v in m_gn.items():
            assert np.isfinite(float(v)), k


class TestStyleLossModes:
    """Gradient-routing matrix of OptimizerConfig.style_loss_mode (SURVEY.md
    defect #2; the modes' dynamics are documented in config.py):

    - G's update: 'adversarial' == 'style_vs_iam' (both feed s_fake_for_g to
      G) but != 'bug_compatible' (G's style grad is zero there).
    - W's update: 'adversarial' == 'bug_compatible' (both train W style-vs-
      generated) but != 'style_vs_iam' (negatives are IAM images).
    - D and R updates: identical across all three modes.
    """

    @pytest.fixture(scope="class")
    def mode_states(self):
        models = build_models(tiny_cfg())
        state = create_train_state(tiny_cfg(), jax.random.PRNGKey(0), models)
        batch, key = make_batch(), jax.random.PRNGKey(2)
        out = {}
        for mode in ("adversarial", "style_vs_iam", "bug_compatible"):
            step = jax.jit(make_train_step(
                tiny_cfg(style_loss_mode=mode), models))
            out[mode] = step(state, batch, key)[0]
        return out

    def test_g_routing(self, mode_states):
        adv, naive, bug = (mode_states[m] for m in
                           ("adversarial", "style_vs_iam", "bug_compatible"))
        assert _delta(adv.g_params, naive.g_params) < 1e-6
        assert _delta(adv.g_params, bug.g_params) > 1e-6

    def test_w_routing(self, mode_states):
        adv, naive, bug = (mode_states[m] for m in
                           ("adversarial", "style_vs_iam", "bug_compatible"))
        assert _delta(adv.w_params, bug.w_params) < 1e-6
        assert _delta(adv.w_params, naive.w_params) > 1e-6

    def test_d_r_invariant(self, mode_states):
        adv, naive, bug = (mode_states[m] for m in
                           ("adversarial", "style_vs_iam", "bug_compatible"))
        for other in (naive, bug):
            assert _delta(adv.d_params, other.d_params) < 1e-6
            assert _delta(adv.r_params, other.r_params) < 1e-6

    def test_deprecated_alias(self):
        models = build_models(tiny_cfg())
        state = create_train_state(tiny_cfg(), jax.random.PRNGKey(0), models)
        batch, key = make_batch(), jax.random.PRNGKey(2)
        s_flag = jax.jit(make_train_step(
            tiny_cfg(bug_compatible_style_loss=True), models))(
                state, batch, key)[0]
        s_mode = jax.jit(make_train_step(
            tiny_cfg(style_loss_mode="bug_compatible"), models))(
                state, batch, key)[0]
        assert _delta(s_flag.g_params, s_mode.g_params) == 0.0
        assert _delta(s_flag.w_params, s_mode.w_params) == 0.0

    def test_unknown_mode_rejected(self):
        with pytest.raises(ValueError):
            make_train_step(tiny_cfg(style_loss_mode="nope"),
                            build_models(tiny_cfg()))


class TestParallel:
    def test_mesh8_matches_mesh1(self):
        """SURVEY.md §5 parity criterion: same numerics as the single-device step
        when the batch is sharded over 8 virtual devices.

        Runs in a SUBPROCESS (with one retry): XLA:CPU's multi-replica all-reduce
        rendezvous can CHECK-fail and abort the host process when its worker
        threads are starved — an abort must fail this test, not kill pytest."""
        import subprocess
        import sys

        cmd = [sys.executable, "-m", "scrabblegan.parallel.selftest", "8"]
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # selftest sets its own device count
        for attempt in range(2):
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=3000, env=env,
                                  cwd=os.path.dirname(os.path.dirname(
                                      os.path.abspath(__file__))))
            if "PARITY-OK" in proc.stdout:
                return
        raise AssertionError(
            f"parity selftest failed after 2 attempts:\n{proc.stdout[-2000:]}\n"
            f"{proc.stderr[-2000:]}")

"""The in-repo module layer (scrabblegan/nn.py) against flax.linen.

The model files import `scrabblegan.nn`. Each test re-imports them with
flax.linen bound to that name, so the same source builds a flax network, and
checks that both layers give the same variable tree and, from the same
variables, the same outputs and updated statistics. flax is a test-only
dependency: without it these tests skip.
"""

import contextlib
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scrabblegan.utils.fakeparams import fake_variables

_MODEL_PKGS = ("scrabblegan.ops", "scrabblegan.models")


@contextlib.contextmanager
def _models_on(nn_module):
    """Import scrabblegan.models afresh with `scrabblegan.nn` -> nn_module;
    restore the original modules on exit."""
    import scrabblegan

    saved = {m: sys.modules.pop(m) for m in list(sys.modules)
             if m.startswith(_MODEL_PKGS)}
    saved_nn = sys.modules["scrabblegan.nn"]
    saved_attrs = {a: getattr(scrabblegan, a) for a in ("nn", "ops", "models")
                   if hasattr(scrabblegan, a)}
    sys.modules["scrabblegan.nn"] = nn_module
    scrabblegan.nn = nn_module
    try:
        yield importlib.import_module("scrabblegan.models")
    finally:
        for m in [m for m in sys.modules if m.startswith(_MODEL_PKGS)]:
            del sys.modules[m]
        sys.modules.update(saved)
        sys.modules["scrabblegan.nn"] = saved_nn
        for a, v in saved_attrs.items():
            setattr(scrabblegan, a, v)


def _shapes(tree):
    return jax.tree_util.tree_map(lambda s: (s.shape, str(s.dtype)), tree)


def _build(models, name):
    if name == "G":
        return models.Generator(vocab_size=52, num_pad_tokens=1)
    if name == "D":
        return models.Discriminator()
    if name == "W":
        return models.StylePromoter()
    if name == "R":
        return models.Recognizer(num_classes=53)
    if name == "R_bilstm":
        return models.BiLSTMRecognizer(num_classes=53)
    if name == "D_dcgan":
        return models.DCGANDiscriminator()
    raise ValueError(name)


def _args(name):
    rng = np.random.default_rng(0)
    imgs = jnp.asarray(rng.uniform(-1, 1, (2, 32, 48, 1)), jnp.float32)
    if name == "G":
        labels = jnp.asarray([[3, 7, 52], [1, 2, 0]], jnp.int32)
        style = jnp.asarray(rng.uniform(-1, 1, (2, 32, 64, 1)), jnp.float32)
        return (labels,), {"style_imgs": style,
                           "lengths": jnp.asarray([2, 3], jnp.int32)}
    return (imgs,), {}


@pytest.mark.parametrize("name", ["G", "D", "W", "R", "R_bilstm", "D_dcgan"])
def test_matches_flax(name):
    flax_nn = pytest.importorskip("flax.linen")
    from scrabblegan import models as ours

    args, kw = _args(name)
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)}
    # BiLSTM R: eval mode (dropout keys differ between the layers); the
    # others in train mode, which also updates BN / spectral-norm statistics
    train = name != "R_bilstm"
    ours_m = _build(ours, name)
    with _models_on(flax_nn) as theirs:
        flax_m = _build(theirs, name)

    ours_shapes = jax.eval_shape(lambda: ours_m.init(rngs, *args, train=train, **kw))
    flax_shapes = jax.eval_shape(lambda: flax_m.init(rngs, *args, train=train, **kw))
    assert _shapes(ours_shapes) == _shapes(dict(flax_shapes))

    variables = fake_variables(flax_shapes, seed=1)
    out_f, mut_f = flax_m.apply(variables, *args, train=train, rngs=rngs,
                                mutable=["batch_stats"], **kw)
    out_o, mut_o = ours_m.apply(variables, *args, train=train, rngs=rngs,
                                mutable=["batch_stats"], **kw)
    assert out_o.shape == out_f.shape and out_o.dtype == out_f.dtype
    np.testing.assert_allclose(np.asarray(out_o), np.asarray(out_f),
                               rtol=1e-5, atol=1e-5)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                rtol=1e-5, atol=1e-6),
        dict(mut_o), dict(mut_f))


def test_init_values_independent_of_build_order():
    """A param's initial value depends on its path, not on creation order."""
    from scrabblegan import nn

    class AB(nn.Module):
        swap: bool = False

        @nn.compact
        def __call__(self, x):
            a, b = nn.Dense(3, name="a"), nn.Dense(3, name="b")
            return (b(x) + a(x)) if self.swap else (a(x) + b(x))

    x = jnp.ones((1, 4))
    v1 = AB().init(jax.random.PRNGKey(0), x)
    v2 = AB(swap=True).init(jax.random.PRNGKey(0), x)
    jax.tree_util.tree_map(np.testing.assert_array_equal, v1, v2)
    assert not np.array_equal(v1["params"]["a"]["kernel"],
                              v1["params"]["b"]["kernel"])


def test_immutable_stats_raise_and_mutable_return():
    from scrabblegan import nn

    bn = nn.BatchNorm(use_running_average=False)
    x = jnp.arange(12.0).reshape(4, 3)
    v = bn.init(jax.random.PRNGKey(0), x)
    assert set(v) == {"params", "batch_stats"}
    np.testing.assert_array_equal(v["batch_stats"]["mean"], np.zeros(3))
    with pytest.raises(ValueError, match="not mutable"):
        bn.apply(v, x)
    _, mut = bn.apply(v, x, mutable=["batch_stats"])
    np.testing.assert_allclose(mut["batch_stats"]["mean"],
                               0.01 * np.asarray(x).mean(0), rtol=1e-6)
    # the caller's tree is not modified in place
    np.testing.assert_array_equal(v["batch_stats"]["mean"], np.zeros(3))

"""Matmul/conv FLOP accounting tests: known closed-form cases + model-level sanity."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from scrabblegan.utils.flops import matmul_flops


class TestKnownCounts:
    def test_plain_matmul(self):
        a = jnp.zeros((8, 32))
        b = jnp.zeros((32, 16))
        got = matmul_flops(lambda x, y: x @ y, a, b)
        assert got == 2 * 8 * 16 * 32

    def test_batched_einsum(self):
        a = jnp.zeros((4, 8, 32))
        b = jnp.zeros((4, 32, 16))
        got = matmul_flops(lambda x, y: jnp.einsum("bij,bjk->bik", x, y), a, b)
        assert got == 2 * 4 * 8 * 16 * 32

    def test_conv2d(self):
        x = jnp.zeros((2, 16, 16, 8))
        k = jnp.zeros((3, 3, 8, 4))
        got = matmul_flops(
            lambda x, k: jax.lax.conv_general_dilated(
                x, k, (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC")), x, k)
        assert got == 2 * (2 * 16 * 16 * 4) * (3 * 3 * 8)

    def test_grad_adds_backward_flops(self):
        a = jnp.zeros((8, 32))
        w = jnp.zeros((32, 16))
        fwd = matmul_flops(lambda w: jnp.sum(a @ w), w)
        fwd_bwd = matmul_flops(jax.grad(lambda w: jnp.sum(a @ w)), w)
        # backward of one matmul = one matmul w.r.t. w (a^T @ dout); jax may
        # also emit the dx matmul depending on the pullback — at least 2x total
        assert fwd_bwd >= 2 * fwd

    def test_scan_multiplies_by_length(self):
        w = jnp.zeros((16, 16))

        def f(w):
            def body(c, _):
                return c @ w, ()
            out, _ = jax.lax.scan(body, jnp.zeros((4, 16)), None, length=7)
            return out
        assert matmul_flops(f, w) == 7 * 2 * 4 * 16 * 16


class TestModelCounts:
    def test_generator_flops_scale_with_length(self):
        from scrabblegan.config import Config, SharedSpecs
        from scrabblegan.train.state import build_models

        cfg = Config(shared=dataclasses.replace(
            SharedSpecs(), z_source="noise", use_pallas_attention=False))
        gen = build_models(cfg).generator
        z = jnp.zeros((2, 128))

        def flops_at(length):
            labels = jnp.zeros((2, length), jnp.int32)
            variables = jax.eval_shape(
                lambda: gen.init(jax.random.PRNGKey(0), labels, z=z,
                                 train=False))
            # abstract call: trace apply on shape structs via eval_shape-built
            # zeros is wasteful; trace with real (tiny) arrays instead
            variables = jax.tree.map(
                lambda s: jnp.zeros(s.shape, s.dtype), variables)
            return matmul_flops(
                lambda v, l, zz: gen.apply(v, l, z=zz, train=False),
                variables, labels, z)

        f5, f10 = flops_at(5), flops_at(10)
        assert f5 > 1e8  # conv stacks are hundreds of MFLOPs per image
        # fully convolutional over width: ~2x flops at 2x length (attention
        # adds a quadratic term, disabled here)
        np.testing.assert_allclose(f10 / f5, 2.0, rtol=0.15)


class TestFlopsCache:
    """matmul_flops_cached (bench.py): persistent JSON cache keyed on
    salt + arg shapes/dtypes + jax version."""

    def _fn(self, x):
        return x @ x

    def test_hit_skips_retrace(self, tmp_path, monkeypatch):
        from scrabblegan.utils import flops as F

        path = str(tmp_path / "cache.json")
        x = jnp.zeros((8, 8))
        a = F.matmul_flops_cached(self._fn, x, salt="s", cache_path=path)
        assert a == 2 * 8 * 8 * 8
        calls = []
        monkeypatch.setattr(F, "matmul_flops",
                            lambda *a, **k: calls.append(1) or 0)
        b = F.matmul_flops_cached(self._fn, x, salt="s", cache_path=path)
        assert b == a and not calls  # served from disk, no retrace

    def test_salt_and_shape_invalidate(self, tmp_path):
        from scrabblegan.utils import flops as F

        path = str(tmp_path / "cache.json")
        x = jnp.zeros((8, 8))
        F.matmul_flops_cached(self._fn, x, salt="a", cache_path=path)
        import json

        n1 = len(json.load(open(path)))
        F.matmul_flops_cached(self._fn, x, salt="b", cache_path=path)
        F.matmul_flops_cached(self._fn, jnp.zeros((4, 4)), salt="a",
                              cache_path=path)
        assert len(json.load(open(path))) == n1 + 2

    def test_no_cache_path_passthrough(self):
        from scrabblegan.utils import flops as F

        assert F.matmul_flops_cached(self._fn, jnp.zeros((2, 2))) == 16

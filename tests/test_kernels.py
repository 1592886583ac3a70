"""The fused attention kernel (kernels/attention.py) against the plain reference.

On the CPU the kernel body runs through the Pallas interpreter; the CUDA
lowering is checked with jax.export, which runs the Pallas -> Triton lowering
without a GPU. Timing and the compiled kernel on the card are chip_smoke.py's
job."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scrabblegan.kernels.attention import (TILES, kernel_layout, nonlocal_attention,
                                           reference_attention, triton_attention)

# (Q, K) of every attention site: generator block B3 at word lengths 5 and
# 10, the style encoder / discriminator block B1 on the 160 px canvas, and a
# shape that needs masked tails on both axes.
SHAPES = {"G_len5": (2560, 640), "G_len10": (5120, 1280), "D_style": (1280, 320),
          "tail": (200, 50)}
# f32: scores at full f32 in both, so only summation order differs.
# bf16: both round the softmax weights to bf16, at different points.
TOL = {jnp.float32: 1e-5, jnp.bfloat16: 3e-2}


def _operands(seed, q, k, dtype, b=1, ca=8, cg=32):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return (jax.random.normal(k1, (b, q, ca), jnp.float32).astype(dtype),
            jax.random.normal(k2, (b, k, ca), jnp.float32).astype(dtype),
            jax.random.normal(k3, (b, k, cg), jnp.float32).astype(dtype))


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


class TestNonlocalAttention:
    @pytest.mark.parametrize("q,k", [(512, 128), (1280, 320)])
    def test_matches_xla_path(self, q, k):
        """On CPU the public op lowers the reference itself."""
        theta, phi, g = _operands(0, q, k, jnp.float32, b=2)
        np.testing.assert_array_equal(np.asarray(nonlocal_attention(theta, phi, g)),
                                      np.asarray(reference_attention(theta, phi, g)))

    def test_gradients_match_xla_path(self):
        """The custom VJP agrees with autodiff through the reference."""
        theta, phi, g = _operands(6, 128, 32, jnp.float32)

        def loss(fn):
            return lambda *a: jnp.sum(jnp.sin(fn(*a)))

        got = jax.grad(loss(nonlocal_attention), argnums=(0, 1, 2))(theta, phi, g)
        ref = jax.grad(loss(reference_attention), argnums=(0, 1, 2))(theta, phi, g)
        for a, b in zip(got, ref):
            _close(a, b, 1e-5)

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                             ids=["f32", "bf16"])
    @pytest.mark.parametrize("site", list(SHAPES))
    def test_triton_kernel_interpret(self, site, dtype):
        q, k = SHAPES[site]
        theta, phi, g = _operands(1, q, k, dtype)
        got = triton_attention(theta, phi, g, interpret=True)
        assert got.shape == (1, q, 32) and got.dtype == dtype
        _close(got, reference_attention(theta, phi, g), TOL[dtype])

    @pytest.mark.parametrize("q,k,qb_splits", [(512, 128, 8), (1280, 320, 20),
                                               (5120, 1280, 80)])
    def test_kernel_body_in_interpret_mode(self, q, k, qb_splits):
        """Several images and several Q blocks per image; K spans one tile
        (K=128) or several."""
        block_q, block_k = TILES[jnp.dtype(jnp.float32)][:2]
        lay = kernel_layout(q, k, 8, 32, block_q, block_k)
        assert lay["q"] // lay["block_q"] == qb_splits
        theta, phi, g = _operands(10, q, k, jnp.float32, b=2)
        _close(triton_attention(theta, phi, g, interpret=True),
               reference_attention(theta, phi, g), TOL[jnp.float32])

    def test_kernel_body_bf16_inputs_interpret(self):
        """Value width 16, the least the kernel takes."""
        theta, phi, g = _operands(13, 256, 64, jnp.bfloat16, cg=16)
        got = triton_attention(theta, phi, g, interpret=True)
        assert got.dtype == jnp.bfloat16
        _close(got, reference_attention(theta, phi, g), TOL[jnp.bfloat16])

    def test_rows_are_convex_combinations(self):
        """softmax attention output must lie within [min(g), max(g)] per channel."""
        theta, phi, g = _operands(3, 256, 64, jnp.float32)
        out = np.asarray(triton_attention(theta, phi, g, interpret=True))
        assert out.max() <= float(g.max()) + 1e-5
        assert out.min() >= float(g.min()) - 1e-5


class TestLayout:
    def test_padding_and_tiles(self):
        lay = kernel_layout(200, 50, 8, 32, 128, 64)
        assert lay["ca"] == 16  # Q/K width padded to the least dot width
        assert lay["q"] % lay["block_q"] == 0 and lay["q"] >= 200
        assert lay["k"] % lay["block_k"] == 0 and lay["k"] >= 50
        assert lay["block_k"] & (lay["block_k"] - 1) == 0

    @pytest.mark.parametrize("ca,cg", [(32, 32), (8, 24), (8, 8)])
    def test_rejects_shapes_it_cannot_take(self, ca, cg):
        with pytest.raises(ValueError):
            kernel_layout(256, 64, ca, cg, 64, 128)

    def test_tiles_are_powers_of_two_and_dtype_keyed(self):
        for block_q, block_k, warps, stages in TILES.values():
            assert all(n & (n - 1) == 0 for n in (block_q, block_k, warps))
        with pytest.raises(ValueError, match="takes"):
            triton_attention(*_operands(0, 64, 16, jnp.float16), interpret=True)


class TestLowering:
    @staticmethod
    def _hlo(platforms, dtype):
        from jax import export

        args = _operands(0, 2560, 640, dtype, b=2)
        exp = export.export(
            jax.jit(nonlocal_attention), platforms=platforms,
            disabled_checks=[export.DisabledSafetyCheck.custom_call(
                "__gpu$xla.gpu.triton")])(*args)
        return exp.mlir_module()

    @pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                             ids=["f32", "bf16"])
    def test_kernel_lowers_for_cuda(self, dtype):
        """Runs the real Pallas -> Triton lowering (the step that refuses a
        dot narrower than 16) at the len-5 generator shape."""
        assert self._hlo(["cuda"], dtype).count("__gpu$xla.gpu.triton") == 1

    def test_cpu_lowers_no_triton_call(self):
        assert "triton" not in self._hlo(["cpu"], jnp.float32)
        text = jax.jit(nonlocal_attention).lower(
            *_operands(0, 256, 64, jnp.float32)).as_text()
        assert "triton" not in text


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_compiled_kernel_on_card(gpu, dtype):
    """The kernel as compiled for the card, at the len-10 generator shape."""
    args = jax.device_put(_operands(4, *SHAPES["G_len10"], dtype, b=4), gpu)
    fn = jax.jit(nonlocal_attention)
    assert "triton" in fn.lower(*args).compile().as_text()
    # f32: the value product runs in TF32 on the card, in kernel and reference
    _close(fn(*args), jax.jit(reference_attention)(*args),
           {jnp.float32: 5e-3, jnp.bfloat16: 3e-2}[dtype])


class TestKernelInModels:
    def test_init_state_under_default_device(self):
        """The kernel changes no parameter: the train state built with and
        without it is identical, leaf for leaf."""
        from scrabblegan.config import load_config
        from scrabblegan.train.state import build_models, create_train_state

        cfg = load_config(None, {"shared.batch_size": 2, "io.bucket_size": 3})
        rng = jax.random.PRNGKey(0)
        plain = create_train_state(cfg, rng, build_models(cfg, use_pallas_attention=False))
        ref = create_train_state(cfg, rng, build_models(cfg))
        assert jax.tree.structure(plain) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(plain), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

"""Fused attention core of the SAGAN non-local block, as a Pallas kernel for
NVIDIA GPUs (Triton route).

    out = softmax(theta @ phi^T) @ g      theta (B, Q, Ca), phi (B, K, Ca),
                                          g (B, K, Cg) -> out (B, Q, Cg)

with no 1/sqrt(d) scaling (the reference's NonLocalBlock, arch_ops.py:51-61).
The plain version writes the (Q, K) score matrix to device memory and reads
it back for the softmax and the value product: at batch 1024 and word length
10 that is 26.8 GB of f32 scores per generator call. Here one program per
(image, block of Q rows) walks the K axis in tiles with an online softmax
(running max, running sum and running output in f32 registers), so the scores
never leave the SM.

Shapes. Ca is 8 at every attention site; it is zero-padded to 16, the least
contraction width Triton's dot takes, which leaves the scores exact. Q and K
are padded to whole tiles: padded keys are masked out of the softmax, padded
query rows are dropped. A shape the kernel cannot take raises; it never falls
back.

Precision. For f32 operands the scores product runs at full f32 in kernel and
reference alike, because exp amplifies score error; the value product runs at
the default precision (TF32 on the GPU), as XLA's does. bf16 operands multiply
in bf16 with f32 accumulation, and the softmax weights are rounded to bf16 for
the value product.

Platform. `jax.lax.platform_dependent` chooses by the platform the computation
is lowered for: CUDA lowers the kernel, every other platform the plain
reference. The backward pass is XLA's VJP of the reference, which recomputes
the scores (ROADMAP.md lists a two-pass Triton backward).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

_LOG2E = math.log2(math.e)
_MASK_VALUE = -0.7 * float(jnp.finfo(jnp.float32).max)
_MIN_DOT_WIDTH = 16  # tl.dot needs every dimension of its right operand >= 16

# (block_q, block_k, num_warps, num_stages) by operand dtype: the fastest of
# a sweep on an H100 at the len-10 generator site (scripts/attention_ab.py
# --section tune; PERF.md, Findings).
TILES = {jnp.dtype(jnp.bfloat16): (128, 64, 4, 3),
         jnp.dtype(jnp.float32): (64, 128, 4, 3)}


def _scores_precision(dtype):
    return lax.Precision.HIGHEST if dtype == jnp.float32 else None


def reference_attention(theta, phi, g):
    """The plain XLA version: the (Q, K) scores are materialized."""
    scores = jnp.einsum("bqc,bkc->bqk", theta, phi,
                        precision=_scores_precision(theta.dtype),
                        preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(scores, axis=-1).astype(theta.dtype)
    return jnp.einsum("bqk,bkc->bqc", attn, g,
                      preferred_element_type=jnp.float32).astype(theta.dtype)


def _attention_kernel(q_ref, k_ref, v_ref, o_ref, *, k_len: int, block_k: int):
    # q_ref (BQ, CA), k_ref (KP, CA), v_ref (KP, CG) -> o_ref (BQ, CG)
    block_q, cg = q_ref.shape[0], v_ref.shape[1]
    q = pltriton.load(q_ref)
    precision = _scores_precision(q.dtype)

    def body(j, carry):
        o, m, l = carry
        keys = pl.ds(j * block_k, block_k)
        k = pltriton.load(k_ref.at[keys, :])
        s = pl.dot(q, k, trans_b=True, precision=precision) * _LOG2E
        if k_len % block_k:
            valid = j * block_k + jnp.arange(block_k) < k_len
            s = jnp.where(valid[None, :], s, _MASK_VALUE)
        m_new = jnp.maximum(m, jnp.max(s, axis=1))
        alpha = jnp.exp2(m - m_new)
        p = jnp.exp2(s - m_new[:, None])
        v = pltriton.load(v_ref.at[keys, :])
        o = alpha[:, None] * o + pl.dot(p.astype(v.dtype), v)
        return o, m_new, alpha * l + jnp.sum(p, axis=1)

    init = (jnp.zeros((block_q, cg), jnp.float32),
            jnp.full((block_q,), -jnp.inf, jnp.float32),
            jnp.zeros((block_q,), jnp.float32))
    o, _, l = lax.fori_loop(0, pl.cdiv(k_len, block_k), body, init)
    pltriton.store(o_ref, (o / l[:, None]).astype(o_ref.dtype))


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def kernel_layout(q: int, k: int, ca: int, cg: int, block_q: int,
                  block_k: int) -> dict:
    """Padded widths and tiles the kernel runs at; raises for shapes it
    cannot take."""
    if ca > _MIN_DOT_WIDTH:
        raise ValueError(f"attention kernel takes Q/K width <= {_MIN_DOT_WIDTH}, got {ca}")
    if cg < _MIN_DOT_WIDTH or cg & (cg - 1):
        raise ValueError(f"attention kernel takes a power-of-two value width "
                         f">= {_MIN_DOT_WIDTH}, got {cg}")
    block_k = min(block_k, max(_MIN_DOT_WIDTH, pl.next_power_of_2(k)))
    return {"ca": _MIN_DOT_WIDTH, "block_q": block_q, "block_k": block_k,
            "q": _round_up(q, block_q), "k": _round_up(k, block_k)}


def triton_attention(theta, phi, g, *, interpret: bool = False, tiles=None):
    """The kernel path on its own: pads, launches, slices. interpret=True runs
    the kernel body through the Pallas interpreter (how the CPU tests run it);
    `tiles` overrides TILES[dtype] (for tuning, scripts/attention_ab.py)."""
    if not theta.dtype == phi.dtype == g.dtype:
        raise ValueError(f"mixed dtypes {theta.dtype}, {phi.dtype}, {g.dtype}")
    if tiles is None and theta.dtype not in TILES:
        raise ValueError(f"attention kernel takes {sorted(map(str, TILES))}, "
                         f"got {theta.dtype}")
    block_q, block_k, num_warps, num_stages = tiles or TILES[theta.dtype]
    b, q, ca = theta.shape
    k, cg = g.shape[1], g.shape[2]
    lay = kernel_layout(q, k, ca, cg, block_q, block_k)
    theta = jnp.pad(theta, ((0, 0), (0, lay["q"] - q), (0, lay["ca"] - ca)))
    phi = jnp.pad(phi, ((0, 0), (0, lay["k"] - k), (0, lay["ca"] - ca)))
    g = jnp.pad(g, ((0, 0), (0, lay["k"] - k), (0, 0)))
    bq = lay["block_q"]
    out = pl.pallas_call(
        functools.partial(_attention_kernel, k_len=k, block_k=lay["block_k"]),
        out_shape=jax.ShapeDtypeStruct((b, lay["q"], cg), theta.dtype),
        grid=(b, lay["q"] // bq),
        in_specs=[
            pl.BlockSpec((None, bq, lay["ca"]), lambda i, j: (i, j, 0)),
            pl.BlockSpec((None, lay["k"], lay["ca"]), lambda i, j: (i, 0, 0)),
            pl.BlockSpec((None, lay["k"], cg), lambda i, j: (i, 0, 0)),
        ],
        out_specs=pl.BlockSpec((None, bq, cg), lambda i, j: (i, j, 0)),
        compiler_params=pltriton.CompilerParams(num_warps=num_warps,
                                                num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name="nonlocal_attention",
    )(theta, phi, g)
    return out[:, :q]


def _forward(theta, phi, g):
    return lax.platform_dependent(theta, phi, g, cuda=triton_attention,
                                  default=reference_attention)


@jax.custom_vjp
def nonlocal_attention(theta, phi, g):
    """theta: (B, Q, Ca); phi: (B, K, Ca); g: (B, K, Cg) -> (B, Q, Cg).

    The kernel when lowered for CUDA, the plain reference elsewhere; the
    gradient is the reference's (see the module docstring)."""
    return _forward(theta, phi, g)


def _fwd(theta, phi, g):
    return _forward(theta, phi, g), (theta, phi, g)


def _bwd(residuals, d_out):
    _, vjp = jax.vjp(reference_attention, *residuals)
    return vjp(d_out)


nonlocal_attention.defvjp(_fwd, _bwd)

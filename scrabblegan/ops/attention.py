"""SAGAN non-local (self-attention) block.

Capability parity with the reference's NonLocalBlock (arch_ops.py:5-72): 1x1 convs
theta (C/8), phi (C/8, maxpool 2x2), g (C/2, maxpool 2x2); attn = softmax(theta phi^T);
output = input + sigma * conv1x1(attn g) with a learned scalar `sigma` initialized to 0.

This is the only O((HW)^2) op in the framework (SURVEY.md §5 "sequence-scaling
analog": image width is the sequence axis, max 160px). With use_pallas=False the
attention core is the plain XLA version (kernels/attention.py:
reference_attention); with use_pallas=True it is the fused kernel on CUDA
(kernels/attention.nonlocal_attention). `dataflow` selects how the three 1x1
projections around the core run; both forms compute the same function on one
shared param tree (tested):

- 'nhwc1' (default): the three projections as ONE matmul on identity-extracted
  spectrally-normalized kernels — x read once, one activation written.
- 'nhwc': three 1x1 convs.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from scrabblegan import nn
from scrabblegan.kernels.attention import nonlocal_attention, reference_attention
from scrabblegan.ops.layers import SNConv


def _extract_kernel(conv: SNConv, c_in: int, dtype, train: bool):
    """Spectrally-normalized 1x1 kernel as a (c_in, c_out) matrix.

    Applying the conv to a (1, 1, c_in, c_in) identity image yields exactly
    W/sigma(W) row by row — the SN power iteration depends only on the kernel,
    so the stats update is identical to a call on real data, and the param /
    batch_stats trees (hence checkpoints) are shared with the NHWC path."""
    eye = jnp.eye(c_in, dtype=dtype)[None, None]  # (1, 1, c_in, c_in)
    return conv(eye, train)[0, 0]  # (c_in, c_out)


class NonLocalBlock(nn.Module):
    use_sn: bool = True
    use_pallas: bool = False
    dataflow: str = "nhwc1"  # 'nhwc1' | 'nhwc' (module docstring)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True):
        b, h, w, c = x.shape
        c_attn = c // 8
        c_g = c // 2
        if self.dataflow not in ("nhwc", "nhwc1"):
            raise ValueError(f"Unknown attention dataflow: {self.dataflow!r}")

        theta_conv = SNConv(c_attn, (1, 1), use_bias=False, use_sn=self.use_sn,
                            dtype=self.dtype, name="theta")
        phi_conv = SNConv(c_attn, (1, 1), use_bias=False, use_sn=self.use_sn,
                          dtype=self.dtype, name="phi")
        g_conv = SNConv(c_g, (1, 1), use_bias=False, use_sn=self.use_sn,
                        dtype=self.dtype, name="g")
        out_conv = SNConv(c, (1, 1), use_bias=False, use_sn=self.use_sn,
                          dtype=self.dtype, name="out")
        sigma = self.param("sigma", nn.initializers.zeros, ())

        if self.use_pallas and self.dataflow == "nhwc1":
            w3 = jnp.concatenate(
                [_extract_kernel(conv, c, self.dtype, train)
                 for conv in (theta_conv, phi_conv, g_conv)], axis=1)
            proj = jnp.einsum("bhwc,cd->bhwd", x, w3)
            theta = proj[..., :c_attn]
            phi = proj[..., c_attn:2 * c_attn]
            g = proj[..., 2 * c_attn:]
        else:
            theta = theta_conv(x, train)
            phi = phi_conv(x, train)
            g = g_conv(x, train)

        phi = nn.max_pool(phi, (2, 2), strides=(2, 2))
        g = nn.max_pool(g, (2, 2), strides=(2, 2))

        theta_flat = theta.reshape(b, h * w, c_attn)
        phi_flat = phi.reshape(b, (h // 2) * (w // 2), c_attn)
        g_flat = g.reshape(b, (h // 2) * (w // 2), c_g)

        attend = nonlocal_attention if self.use_pallas else reference_attention
        attn_g = attend(theta_flat, phi_flat, g_flat)
        attn_g = attn_g.reshape(b, h, w, c_g)
        attn_g = out_conv(attn_g, train)

        return sigma.astype(self.dtype) * attn_g + x

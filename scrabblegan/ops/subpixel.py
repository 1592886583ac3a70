"""Exact subpixel lowering of SAME transposed convolution.

The generator's up-blocks are stride-2 ``Conv2DTranspose`` layers
(reference `/root/reference/src/bigacgan/resnet_ops.py:57-72`). XLA lowers a
transposed conv as a conv over the *input-dilated* operand (zeros inserted
between pixels), so half to three quarters of the multiplies hit
structural zeros. This module computes the identical function as ONE dense
conv producing the ``sh*sw`` output-parity phases as channel groups, followed
by a depth-to-space interleave:

  ``nn.ConvTranspose(padding='SAME')`` computes (per strided dim, stride 2,
  kernel 3, pad_a = 2 on the dilated input):

      y[2m]   = x[m-1] @ k[0] + x[m] @ k[2]
      y[2m+1] = x[m]   @ k[1]

  so every output phase is a stride-1 conv of x with a 2-tap sub-kernel.
  The four (even/odd x even/odd) phase kernels are stacked along the output-
  channel axis, identically-zero phases (e.g. 3 of 4 for the 1x1 skip) are
  pruned from the conv and re-inserted as zeros at interleave time.

Numerics: bit-identical contraction order per output element is not
guaranteed, but the decomposition is exact in exact arithmetic and matches
``nn.ConvTranspose`` to f32 rounding (tested in tests/test_ops.py). Parameter
shape, name, and init match ``nn.ConvTranspose`` so checkpoints are
interchangeable between lowerings.

Despite the 2.25-4x reduction in multiplies, the depth-to-space interleave
here is an extra full-tensor device-memory pass per up-block. Kept as a tested
config option (`shared.conv_lowering='subpixel'`); the default remains
'dilated'. Its speed on the GPU is not measured.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import nn as jnn

from scrabblegan import nn


def _dim_taps(k: int, s: int) -> Sequence[Sequence[int]]:
    """Per output phase, the kernel row feeding each stride-1 conv tap.

    Returns taps[phase][tap_position] = kernel spatial index, or -1 for a
    structurally-zero tap. Tap positions are ordered left-to-right over the
    input window; strided dims left-pad the input by (num_taps - 1).
    Derived from lax.conv_transpose SAME padding: pad_a = ceil((k+s-2)/2) on
    the dilated input (k-1 when s > k-1), output o = s*i + pad_a - a.
    """
    if s == 1:
        return [list(range(k))]
    if s != 2:
        raise NotImplementedError(f"stride {s} not supported (generator uses 1/2)")
    if k == 3:
        return [[0, 2], [-1, 1]]
    if k == 1:
        return [[0], [-1]]
    raise NotImplementedError(f"kernel {k} not supported (generator uses 1/3)")


def conv_transpose_same_subpixel(x: jnp.ndarray, kernel: jnp.ndarray,
                                 strides: Tuple[int, int]) -> jnp.ndarray:
    """NHWC transposed conv, SAME padding, output = input * stride per dim.

    Equals ``nn.ConvTranspose(features, kernel.shape[:2], strides,
    padding='SAME', use_bias=False)`` with the same kernel, to float rounding.
    """
    kh, kw, ci, co = kernel.shape
    sh, sw = strides
    th, tw = _dim_taps(kh, sh), _dim_taps(kw, sw)
    nth, ntw = len(th[0]), len(tw[0])

    # Assemble phase kernels; prune phases that are identically zero.
    phases = [(ph, pw) for ph in range(sh) for pw in range(sw)]
    live = [(ph, pw) for ph, pw in phases
            if any(r >= 0 for r in th[ph]) and any(r >= 0 for r in tw[pw])]
    kz = jnp.zeros((ci, co), kernel.dtype)
    big = jnp.stack([
        jnp.stack([
            jnp.concatenate([
                kernel[th[ph][a], tw[pw][b]]
                if th[ph][a] >= 0 and tw[pw][b] >= 0 else kz
                for ph, pw in live
            ], axis=-1)
            for b in range(ntw)
        ], axis=0)
        for a in range(nth)
    ], axis=0)  # (nth, ntw, ci, len(live)*co)

    pads = [((nt - 1, 0) if s == 2 else ((k - 1) // 2, k // 2))
            for k, s, nt in ((kh, sh, nth), (kw, sw, ntw))]
    y = lax.conv_general_dilated(x, big, (1, 1), pads,
                                 dimension_numbers=("NHWC", "HWIO", "NHWC"))

    b, n, m, _ = y.shape
    if len(live) < len(phases):  # re-insert pruned (all-zero) phases
        y = y.reshape(b, n, m, len(live), co)
        full = jnp.zeros((b, n, m, len(phases), co), y.dtype)
        idx = np.array([phases.index(p) for p in live])
        y = full.at[:, :, :, idx].set(y)
    y = y.reshape(b, n, m, sh, sw, co).transpose(0, 1, 3, 2, 4, 5)
    return y.reshape(b, n * sh, m * sw, co)


class SubpixelConvTranspose(nn.Module):
    """Drop-in ``nn.ConvTranspose(padding='SAME')`` with subpixel lowering.

    Same parameter tree (``kernel`` (kh, kw, in, out), optional ``bias``),
    same orthogonal init, same computation dtype semantics — checkpoints are
    interchangeable with the dilated lowering.
    """

    features: int
    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (2, 2)
    use_bias: bool = True
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x):
        kh, kw = self.kernel_size
        kernel = self.param("kernel", jnn.initializers.orthogonal(column_axis=-1),
                            (kh, kw, x.shape[-1], self.features))
        x = x.astype(self.dtype)
        y = conv_transpose_same_subpixel(x, kernel.astype(self.dtype),
                                         tuple(self.strides))
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros, (self.features,))
            y = y + bias.astype(self.dtype)
        return y

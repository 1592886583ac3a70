"""Base layers: orthogonally-initialized Conv / ConvTranspose / Dense with optional
TRUE spectral normalization.

The reference wires `spectral_norm` as a Keras kernel_regularizer whose output is
never consumed and which resamples its power-iteration vector every call
(`src/bigacgan/arch_ops.py:99-126`; SURVEY.md defect #3) — i.e. it has no effect.
Here spectral norm is implemented the intended way: a weight reparametrization
w / sigma(w) with a PERSISTENT power-iteration vector `u` carried in the
'batch_stats' collection and updated once per training step (nn.SpectralNorm).
Setting use_sn=False reproduces the reference's *effective* (un-normalized) behavior.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import jax.numpy as jnp
from jax import nn as jnn

from scrabblegan import nn


def orthogonal_init():
    """Orthogonal kernel init, matching tf.initializers.orthogonal() used on every
    conv/dense kernel in the reference (e.g. resnet_ops.py:57,65)."""
    return jnn.initializers.orthogonal(column_axis=-1)


class SNConv(nn.Module):
    """3x3/1x1 conv with orthogonal init and optional spectral norm."""

    features: int
    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    padding: str = "SAME"
    use_bias: bool = True
    use_sn: bool = True
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True):
        conv = nn.Conv(
            self.features,
            self.kernel_size,
            strides=self.strides,
            padding=self.padding,
            use_bias=self.use_bias,
            kernel_init=orthogonal_init(),
            dtype=self.dtype,
        )
        if self.use_sn:
            return nn.SpectralNorm(conv)(x, update_stats=train)
        return conv(x)


class SNConvTranspose(nn.Module):
    """Transposed conv (upsampling) with orthogonal init and optional spectral norm.

    Reference uses layers.Conv2DTranspose with 'same' padding so output spatial dims
    are exactly input * stride (resnet_ops.py:57-59,69-72).

    lowering='subpixel' computes the identical function as a dense stride-1
    conv over output-parity phases + depth-to-space (ops/subpixel.py, exactness
    tested); 'dilated' (default) is the stock nn.ConvTranspose path (the
    subpixel interleave is an extra device-memory pass). Both share one
    param tree (inner module is named ConvTranspose_0 either way), so
    checkpoints are interchangeable."""

    features: int
    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (2, 2)
    use_bias: bool = True
    use_sn: bool = True
    lowering: str = "dilated"  # 'dilated' | 'subpixel'
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True):
        if self.lowering == "subpixel":
            from scrabblegan.ops.subpixel import SubpixelConvTranspose

            conv = SubpixelConvTranspose(
                self.features,
                self.kernel_size,
                strides=self.strides,
                use_bias=self.use_bias,
                dtype=self.dtype,
                name="ConvTranspose_0",
            )
        elif self.lowering == "dilated":
            conv = nn.ConvTranspose(
                self.features,
                self.kernel_size,
                strides=self.strides,
                padding="SAME",
                use_bias=self.use_bias,
                kernel_init=orthogonal_init(),
                dtype=self.dtype,
                name="ConvTranspose_0",
            )
        else:
            raise ValueError(f"Unknown conv-transpose lowering: {self.lowering!r}")
        if self.use_sn:
            return nn.SpectralNorm(conv)(x, update_stats=train)
        return conv(x)


class SNDense(nn.Module):
    """Dense with orthogonal init and optional spectral norm."""

    features: int
    use_bias: bool = False
    use_sn: bool = True
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True):
        dense = nn.Dense(
            self.features,
            use_bias=self.use_bias,
            kernel_init=orthogonal_init(),
            dtype=self.dtype,
        )
        if self.use_sn:
            return nn.SpectralNorm(dense)(x, update_stats=train)
        return dense(x)

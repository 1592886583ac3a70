"""BigGAN-style ResNet up/down blocks and conditional batch norm, as
modules with explicit train-mode state threading (BN running stats + spectral-norm
power-iteration vectors live in the 'batch_stats' collection).

Capability parity with the reference's resnet_ops.py:
- ConditionalBatchNorm (resnet_ops.py:5-33): non-affine BN followed by per-channel
  scale/shift produced by two bias-free orthogonal Dense layers on a conditioning
  vector (the hierarchical-z chunk).
- ResNetBlockUp (resnet_ops.py:36-81): CBN -> relu -> ConvTranspose 3x3 (stride
  (2,2), or (2,1) on the last block to realize ScrabbleGAN's 16px-per-char width
  algebra) -> CBN -> relu -> Conv 3x3, plus a 1x1 ConvTranspose skip.
- ResNetBlockDown (resnet_ops.py:84-120): relu -> Conv 3x3 -> relu -> Conv 3x3 ->
  AvgPool 2x2 'SAME' (skipped on the last block), plus a 1x1 Conv (+pool) skip.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from scrabblegan import nn
from scrabblegan.ops.layers import SNConv, SNConvTranspose, SNDense


class ConditionalBatchNorm(nn.Module):
    """Class-conditional BN (https://arxiv.org/pdf/1707.00683.pdf)."""

    use_sn: bool = True
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, cond, train: bool = True):
        h = nn.BatchNorm(
            use_running_average=not train,
            use_scale=False,
            use_bias=False,
            dtype=self.dtype,
        )(x)
        num_channels = x.shape[-1]
        gamma = SNDense(num_channels, use_bias=False, use_sn=self.use_sn, dtype=self.dtype, name="gamma")(
            cond, train
        )
        beta = SNDense(num_channels, use_bias=False, use_sn=self.use_sn, dtype=self.dtype, name="beta")(
            cond, train
        )
        return h * gamma[:, None, None, :] + beta[:, None, None, :]


class ResNetBlockUp(nn.Module):
    """Upsampling ResNet block with CBN conditioning.

    Doubles height; doubles width unless `is_last_block`, where the width stride is 1
    so the generator's final width is exactly 16px per character (resnet_ops.py:54,
    net_architecture.py:221)."""

    features: int
    is_last_block: bool = False
    use_sn: bool = True
    conv_lowering: str = "dilated"
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, cond, train: bool = True):
        strides = (2, 1) if self.is_last_block else (2, 2)

        h = ConditionalBatchNorm(use_sn=self.use_sn, dtype=self.dtype, name="cbn1")(x, cond, train)
        h = nn.relu(h)
        h = SNConvTranspose(
            self.features, (3, 3), strides=strides, use_sn=self.use_sn,
            lowering=self.conv_lowering, dtype=self.dtype, name="upconv"
        )(h, train)
        h = ConditionalBatchNorm(use_sn=self.use_sn, dtype=self.dtype, name="cbn2")(h, cond, train)
        h = nn.relu(h)
        h = SNConv(self.features, (3, 3), use_sn=self.use_sn, dtype=self.dtype, name="conv")(h, train)

        shortcut = SNConvTranspose(
            self.features, (1, 1), strides=strides, use_sn=self.use_sn,
            lowering=self.conv_lowering, dtype=self.dtype, name="skip"
        )(x, train)
        return h + shortcut


class ResNetBlockDown(nn.Module):
    """Downsampling ResNet block (no normalization, like BigGAN's D blocks)."""

    features: int
    is_last_block: bool = False
    use_sn: bool = True
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True):
        h = nn.relu(x)
        h = SNConv(self.features, (3, 3), use_sn=self.use_sn, dtype=self.dtype, name="conv1")(h, train)
        h = nn.relu(h)
        h = SNConv(self.features, (3, 3), use_sn=self.use_sn, dtype=self.dtype, name="conv2")(h, train)
        if not self.is_last_block:
            h = nn.avg_pool(h, (2, 2), strides=(2, 2), padding="SAME")

        shortcut = SNConv(self.features, (1, 1), use_sn=self.use_sn, dtype=self.dtype, name="skip")(
            x, train
        )
        if not self.is_last_block:
            shortcut = nn.avg_pool(shortcut, (2, 2), strides=(2, 2), padding="SAME")
        return h + shortcut

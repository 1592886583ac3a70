"""BigGAN discriminator and the DCGAN-style `my_disc` variant.

Capability parity with make_discriminator (net_architecture.py:299-355) and
make_my_discriminator (net_architecture.py:417-462). Both are fully convolutional
over width: they accept any bucket width (one XLA compilation per bucket) and reduce
with a global average pool, so a single parameter set serves all word lengths —
the static-shape replacement for the reference's `w=None` dynamic shapes.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from scrabblegan import nn
from scrabblegan.ops.attention import NonLocalBlock
from scrabblegan.ops.blocks import ResNetBlockDown
from scrabblegan.ops.layers import SNConv, SNDense, orthogonal_init


def disc_channels(colors: int = 1, resolution: int = 32):
    """Discriminator down-block channels (net_architecture.py:576-586)."""
    ch = 64
    if colors not in (1, 3):
        raise ValueError(f"Unsupported color channels: {colors}")
    if resolution != 32:
        raise ValueError(f"Unsupported resolution: {resolution}")
    multipliers = [1, 8, 16, 16]
    out_channels = [ch * m for m in multipliers]
    in_channels = [colors] + out_channels[:-1]
    return in_channels, out_channels


class _DownTrunk(nn.Module):
    """Shared BigGAN down-stack: 4 ResNet down blocks with optional attention,
    relu, global average pool."""

    blocks_with_attention: str = "B1"
    use_sn: bool = True
    use_pallas_attention: bool = False
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True, width_mask=None):
        _, out_channels = disc_channels(colors=x.shape[-1])
        net = x.astype(self.dtype)
        for idx, feats in enumerate(out_channels):
            name = f"B{idx + 1}"
            is_last = idx == len(out_channels) - 1
            net = ResNetBlockDown(
                feats, is_last_block=is_last, use_sn=self.use_sn, dtype=self.dtype,
                name=f"block_{name}",
            )(net, train)
            if name in self.blocks_with_attention:
                net = NonLocalBlock(use_sn=self.use_sn, use_pallas=self.use_pallas_attention,
                                    dtype=self.dtype, name=f"attn_{name}")(net, train)
        net = nn.relu(net)
        # GAP reduces ~H*W values per channel: accumulate in f32 so a bf16
        # trunk (config.shared.trunk_dtype) doesn't lose the sum's low bits
        net = net.astype(jnp.float32)
        if width_mask is not None:
            # masked GAP for 'padded' shape mode: width_mask (B, W_feat) in {0,1}
            m = width_mask[:, None, :, None].astype(net.dtype)  # (B,1,W,1)
            denom = (net.shape[1] * jnp.sum(width_mask, axis=1)).clip(1.0)  # (B,)
            return jnp.sum(net * m, axis=(1, 2)) / denom[:, None].astype(net.dtype)
        return jnp.mean(net, axis=(1, 2))


class Discriminator(nn.Module):
    """BigGAN D: down trunk + spectral-norm Dense(1) logit head."""

    blocks_with_attention: str = "B1"
    use_sn: bool = True
    use_pallas_attention: bool = False
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True, width_mask=None):
        h = _DownTrunk(self.blocks_with_attention, self.use_sn,
                       self.use_pallas_attention, self.dtype, name="trunk")(
            x, train, width_mask)
        logit = SNDense(1, use_bias=False, use_sn=self.use_sn, dtype=self.dtype,
                        name="head")(h, train)
        return logit[:, 0].astype(jnp.float32)


class DCGANDiscriminator(nn.Module):
    """The `my_disc=1` variant: 4 strided convs (16/32/64/128) + LeakyReLU, attention
    after conv2, GAP, Dense(1) (net_architecture.py:417-462). The reference's call
    site passes arguments in the wrong order and crashes (SURVEY.md defect #4); this
    implementation is callable."""

    use_sn: bool = True
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True, width_mask=None):
        net = x.astype(self.dtype)
        for idx, feats in enumerate((16, 32, 64, 128)):
            net = SNConv(feats, (3, 3), strides=(2, 2), use_sn=self.use_sn,
                         dtype=self.dtype, name=f"conv{idx + 1}")(net, train)
            net = nn.leaky_relu(net, negative_slope=0.3)  # keras LeakyReLU default
            if idx == 1:
                net = NonLocalBlock(use_sn=self.use_sn, dtype=self.dtype,
                                    name="attn_B1")(net, train)
        net = nn.leaky_relu(net, negative_slope=0.3)
        # GAP accumulates in f32 so a bf16 trunk doesn't lose the sum's low
        # bits (same rule as _DownTrunk above)
        net = jnp.mean(net.astype(jnp.float32), axis=(1, 2))
        logit = SNDense(1, use_bias=False, use_sn=self.use_sn, dtype=self.dtype,
                        name="head")(net, train)
        return logit[:, 0].astype(jnp.float32)

"""ScrabbleGAN/BigGAN generator with per-character filter-bank latents, hierarchical
z, CBN ResNet up-blocks, and a pluggable z source.

Capability parity with make_generator (net_architecture.py:182-296):
- z source 'style' (the fork's path): a style image is encoded by a BigGAN down-stack
  (discriminator channel schedule, attention after block 1, GAP, Dense(128)) into the
  128-d latent (net_architecture.py:234-257).
- z source 'noise' (upstream ScrabbleGAN, what run_inference.py exercises — SURVEY.md
  defect #10): a sampled 128-d normal vector is used directly.
- hierarchical z: 128 split into 4x32; z0 contracts the filter bank, chunks 1-3
  condition CBN in up-blocks 1-3 (net_architecture.py:260-262).
- filter bank: per character, z0(32) . patch(32x8192) -> 8192 = 512*4*4, laid out as a
  4x4x512 spatial seed; per-char seeds concatenated along width via the exact
  row-major reshape/transpose chain of net_architecture.py:269-271.
- 3 up-blocks (channels 256/128/64), strides (2,2),(2,2),(2,1): height 4*8=32, width
  4L*4=16L — ScrabbleGAN's 16px-per-char geometry. Attention at 'B3' by default.
- final BN -> relu -> 3x3 conv to image channels -> tanh; output in [-1, 1].
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import jax.numpy as jnp

from scrabblegan import nn
from scrabblegan.ops.attention import NonLocalBlock
from scrabblegan.ops.blocks import ResNetBlockDown, ResNetBlockUp
from scrabblegan.ops.embedding import FilterBank
from scrabblegan.ops.layers import SNConv, SNDense


def gen_channels(resolution: int = 32):
    """Generator up-block output channels (net_architecture.py:565-573)."""
    ch = 64
    if resolution != 32:
        raise ValueError(f"Unsupported resolution: {resolution}")
    multipliers = [8, 4, 2, 1]
    in_channels = [ch * m for m in multipliers[:-1]]
    out_channels = [ch * m for m in multipliers[1:]]
    return in_channels, out_channels


class StyleEncoder(nn.Module):
    """Style-image -> 128-d latent encoder (the fork's generator input path)."""

    latent_dim: int = 128
    use_sn: bool = True
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, style_imgs, train: bool = True):
        from scrabblegan.models.discriminator import disc_channels

        _, out_channels = disc_channels(colors=style_imgs.shape[-1])
        net = style_imgs.astype(self.dtype)
        for idx, feats in enumerate(out_channels):
            is_last = idx == len(out_channels) - 1
            net = ResNetBlockDown(
                feats, is_last_block=is_last, use_sn=self.use_sn, dtype=self.dtype,
                name=f"block{idx + 1}",
            )(net, train)
            if idx == 0:  # attention after B_style1 (net_architecture.py:245-246)
                net = NonLocalBlock(use_sn=self.use_sn, dtype=self.dtype, name="attn")(net, train)
        net = nn.relu(net)
        # f32 accumulation for the pool (see _DownTrunk GAP note)
        net = jnp.mean(net.astype(jnp.float32), axis=(1, 2))
        return SNDense(self.latent_dim, use_bias=False, use_sn=self.use_sn, dtype=self.dtype,
                       name="proj")(net, train)


class Generator(nn.Module):
    vocab_size: int
    latent_dim: int = 128
    embed_y: Tuple[int, int] = (32, 8192)
    blocks_with_attention: str = "B3"
    z_source: str = "style"  # 'style' | 'noise'
    img_channels: int = 1
    img_height: int = 32
    use_sn: bool = True
    use_pallas_attention: bool = False
    conv_lowering: str = "dilated"  # up-block ConvTranspose lowering (ops/subpixel.py)
    # 'padded' shape mode: one extra filter-bank row serves as the PAD token
    # (id == vocab_size) so every batch can be label-padded to a single static
    # length; pass `lengths` to whiten the image beyond 16*len px.
    num_pad_tokens: int = 0
    dtype: Any = jnp.float32
    # Compute dtype for the (BN-free) style-encoder trunk; None = `dtype`.
    # The encoder's 128-d z is cast back to `dtype` before the filter bank,
    # so the CBN/BN-bearing up-stack is unaffected (config.shared.trunk_dtype).
    style_encoder_dtype: Any = None

    @nn.compact
    def __call__(self, labels, style_imgs=None, z: Optional[jnp.ndarray] = None,
                 lengths: Optional[jnp.ndarray] = None, train: bool = True):
        """labels: (B, L) int32 char ids; returns (B, 32, 16L, C) images in [-1, 1].

        lengths: optional (B,) true word lengths ('padded' mode) — output columns
        at or beyond 16*len are forced to white (+1)."""
        in_channels, out_channels = gen_channels(self.img_height)
        num_blocks = len(out_channels)
        seed_hw = self.img_height // 2 ** num_blocks  # 4
        seed_ch = in_channels[0]  # 512; 8192 = 512 * 4 * 4

        if self.z_source == "style":
            if style_imgs is None:
                raise ValueError("z_source='style' requires style_imgs")
            se_dtype = (self.dtype if self.style_encoder_dtype is None
                        else self.style_encoder_dtype)
            z = StyleEncoder(self.latent_dim, use_sn=self.use_sn, dtype=se_dtype,
                             name="style_encoder")(style_imgs, train)
        elif z is None:
            raise ValueError("z_source='noise' requires z")
        z = z.astype(self.dtype)

        # hierarchical z: 128 -> 4 x 32 (net_architecture.py:260-262)
        chunks = jnp.split(z, num_blocks + 1, axis=1)
        z0, z_per_block = chunks[0], chunks[1:]

        # filter bank contraction: per char, z0(32) @ patch(32, 8192) -> 8192,
        # via the fused one-hot matmul (see ops/embedding.py — the gather
        # form costs 2.7GB of HBM bank re-reads per forward at batch 1024)
        net = FilterBank(self.vocab_size + self.num_pad_tokens, self.embed_y,
                         dtype=self.dtype, name="filter_bank").contract(labels, z0)
        net = net.astype(self.dtype)

        # lay per-char patches side by side along width — exact row-major
        # reshape/transpose chain of net_architecture.py:269-271
        b = net.shape[0]
        net = net.reshape(b, seed_ch, seed_hw, seed_hw, -1)
        net = net.reshape(b, -1, seed_ch, seed_hw)
        net = jnp.transpose(net, (0, 3, 1, 2))  # (B, 4, 4L, 512)

        for idx, feats in enumerate(out_channels):
            name = f"B{idx + 1}"
            is_last = idx == num_blocks - 1
            net = ResNetBlockUp(
                feats, is_last_block=is_last, use_sn=self.use_sn,
                conv_lowering=self.conv_lowering, dtype=self.dtype,
                name=f"up_{name}",
            )(net, z_per_block[idx], train)
            if name in self.blocks_with_attention:
                net = NonLocalBlock(use_sn=self.use_sn, use_pallas=self.use_pallas_attention,
                                    dtype=self.dtype, name=f"attn_{name}")(net, train)

        net = nn.BatchNorm(use_running_average=not train, dtype=self.dtype,
                           name="final_bn")(net)
        net = nn.relu(net)
        net = SNConv(self.img_channels, (3, 3), use_sn=self.use_sn, dtype=self.dtype,
                     name="to_image")(net, train)
        out = jnp.tanh(net).astype(self.dtype)
        if lengths is not None:
            width = out.shape[2]
            cols = jnp.arange(width)[None, None, :, None]
            valid = cols < (16 * lengths.astype(jnp.int32))[:, None, None, None]
            out = jnp.where(valid, out, jnp.asarray(1.0, out.dtype))  # white pad
        return out

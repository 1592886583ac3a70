"""Style networks of the fork: the style-promoter adversary W and the (dead-code in
the reference, functional here) style extractor.

Capability parity with make_style_promoter (net_architecture.py:358-414) — a third
adversary byte-identical in architecture to the BigGAN discriminator, trained to
separate target-style images from others so G is pushed to imitate the target
style — and make_style_extractor (net_architecture.py:465-498, constructed nowhere
in the reference; SURVEY.md component 24), the same trunk with a Dense(128)
style-embedding head.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from scrabblegan import nn
from scrabblegan.models.discriminator import _DownTrunk
from scrabblegan.ops.layers import SNDense


class StylePromoter(nn.Module):
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


class StyleExtractor(nn.Module):
    embedding_dim: int = 128
    blocks_with_attention: str = "B1"
    use_sn: bool = True
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True):
        h = _DownTrunk(self.blocks_with_attention, self.use_sn, False, self.dtype,
                       name="trunk")(x, train)
        return SNDense(self.embedding_dim, use_bias=False, use_sn=self.use_sn,
                       dtype=self.dtype, name="head")(h, train).astype(jnp.float32)

"""ScrabbleGAN per-character filter bank (the paper's "spatial embedding").

Capability parity with SpatialEmbedding (arch_ops.py:77-95): a learnable tensor
[vocab, k, d] (default [52, 32, 8192], ~13.6M params — the largest single weight);
a character-id lookup returns per-character patches that the generator contracts
with the z0 latent chunk to form per-character 4x4x512 spatial seeds.

`contract` is the fused form of lookup+contraction. The naive
gather-then-einsum (`bk,blkd->bld`) re-reads a full (k, d) = 512KB bank row
from device memory per (batch, char) — 2.7GB of traffic at batch 1024 x len 5.
Reformulated as
  out = (onehot(ids) (x) z0) @ bank.reshape(V*k, d)
it becomes one dense matmul (M=B*L, K=V*k, N=d) that reads the 28MB bank
once; the extra multiplies against zero one-hot blocks are cheap next to the
gather traffic they replace.
The two forms are numerically identical up to f32-accumulation order.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp

from scrabblegan import nn


class FilterBank(nn.Module):
    vocab_size: int
    filter_dim: Tuple[int, int] = (32, 8192)
    dtype: Any = jnp.float32

    def setup(self):
        self.bank = self.param(
            "filter_bank",
            nn.initializers.glorot_uniform(),
            (self.vocab_size, self.filter_dim[0], self.filter_dim[1]),
        )

    def __call__(self, ids):
        # ids: (B, L) int32 -> (B, L, k, d) per-character patches (gather form)
        return jnp.take(self.bank, ids, axis=0).astype(self.dtype)

    def contract(self, ids, z0):
        """Fused lookup+contraction: (B, L) ids, (B, k) z0 -> (B, L, d).

        Equals einsum('bk,blkd->bld', z0, self(ids)) with f32 accumulation."""
        v, k, d = self.bank.shape
        b, l = ids.shape
        onehot = jax.nn.one_hot(ids.reshape(-1), v, dtype=self.dtype)  # (B*L, V)
        z0_rows = jnp.broadcast_to(
            z0.astype(self.dtype)[:, None, :], (b, l, k)).reshape(b * l, k)
        # A[r, v*k + k'] = onehot[r, v] * z0[row b, k'] — 0/1 scaling, exact
        a = (onehot[:, :, None] * z0_rows[:, None, :]).reshape(b * l, v * k)
        out = jax.lax.dot_general(
            a, self.bank.astype(self.dtype).reshape(v * k, d),
            (((1,), (0,)), ((), ())), preferred_element_type=jnp.float32,
        )  # (B*L, d) f32
        return out.reshape(b, l, d)

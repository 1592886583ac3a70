"""Handwriting recognizers (the GAN's auxiliary "R" network).

Capability parity with make_recognizer (net_architecture.py:9-79) and
make_my_recognizer (net_architecture.py:82-179).

Unlike the reference — whose Keras model OUTPUTS the CTC loss via a Lambda layer —
these modules return per-frame LOGITS (B, T, K); the CTC loss is a pure function
(scrabblegan.ops.ctc.ctc_loss) applied in the train step. This keeps R usable
for decoding at inference and keeps the loss jit-differentiable.

Time-step algebra (must match the reference exactly; SURVEY.md §2 "dimension
algebra"): the default conv CRNN downsamples width by /2,/2 then a kernel-2 VALID
conv, so T = W/4 - 1 = 4*len - 1 for 16px-per-char input.
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from scrabblegan import nn


def ctc_time_steps(width: int, my_rec: bool = False) -> int:
    """Frames produced for an input of pixel width `width`."""
    return width // 4 if my_rec else width // 4 - 1


class Recognizer(nn.Module):
    """Conv-only CRNN per arXiv:1507.05717, RNN layers intentionally omitted
    ("avoid learning implicit language model", net_architecture.py:54).

    Stack: conv64 -> pool(2,2) -> conv128 -> pool(2,2) -> conv256 -> conv256 ->
    pool(2,1) -> conv512 -> BN -> conv512 -> BN -> pool(2,1) -> conv512 k2 VALID
    (squeezes height 2->1) -> per-frame Dense(num_classes).
    """

    num_classes: int  # vocab + 1 (CTC blank = last id)
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True, return_features: bool = False):
        """return_features=True: per-image pooled 512-d conv features instead of
        frame logits (used by the rFID quality metric, scrabblegan.eval.fid)."""
        conv = lambda f, k, name, pad="SAME": nn.Conv(
            f, k, padding=pad, dtype=self.dtype, name=name
        )
        net = x.astype(self.dtype)
        net = nn.relu(conv(64, (3, 3), "conv1")(net))
        net = nn.max_pool(net, (2, 2), strides=(2, 2))
        net = nn.relu(conv(128, (3, 3), "conv2")(net))
        net = nn.max_pool(net, (2, 2), strides=(2, 2))
        net = nn.relu(conv(256, (3, 3), "conv3")(net))
        net = nn.relu(conv(256, (3, 3), "conv4")(net))
        net = nn.max_pool(net, (2, 1), strides=(2, 1))
        net = nn.relu(conv(512, (3, 3), "conv5")(net))
        net = nn.BatchNorm(use_running_average=not train, dtype=self.dtype, name="bn5")(net)
        net = nn.relu(conv(512, (3, 3), "conv6")(net))
        net = nn.BatchNorm(use_running_average=not train, dtype=self.dtype, name="bn6")(net)
        net = nn.max_pool(net, (2, 1), strides=(2, 1))
        net = nn.relu(conv(512, (2, 2), "conv7", pad="VALID")(net))
        net = jnp.squeeze(net, axis=1)  # (B, T, 512), height 2 -> 1
        if return_features:
            return jnp.mean(net, axis=1).astype(jnp.float32)  # (B, 512)
        logits = nn.Dense(self.num_classes, dtype=self.dtype, name="frame_logits")(net)
        return logits.astype(jnp.float32)


class BiLSTMRecognizer(nn.Module):
    """The `my_rec=1` variant: 7 light convs (16..144) with BN + LeakyReLU(0.01) and
    dropout, then 5 bidirectional LSTM(256) layers and a per-frame Dense
    (net_architecture.py:82-179). T = W/4 (no final valid conv); the reference train
    loop still feeds input_length = 4*len - 1, which simply masks the last frame —
    reproduced by the step's length algebra."""

    num_classes: int
    dtype: Any = jnp.float32

    @nn.compact
    def __call__(self, x, train: bool = True):
        def conv_block(net, feats, name, drop=None):
            if drop is not None:
                net = nn.Dropout(drop, deterministic=not train)(net)
            net = nn.Conv(feats, (3, 3), padding="SAME", dtype=self.dtype, name=f"conv_{name}")(net)
            net = nn.BatchNorm(use_running_average=not train, dtype=self.dtype, name=f"bn_{name}")(net)
            return nn.leaky_relu(net, negative_slope=0.01)

        net = x.astype(self.dtype)
        net = conv_block(net, 16, "1")
        net = nn.max_pool(net, (2, 2), strides=(2, 2))
        net = conv_block(net, 32, "2")
        net = nn.max_pool(net, (2, 2), strides=(2, 2))
        net = conv_block(net, 48, "3", drop=0.2)
        net = nn.max_pool(net, (2, 1), strides=(2, 1))
        net = conv_block(net, 64, "4", drop=0.2)
        net = nn.max_pool(net, (2, 1), strides=(2, 1))
        net = conv_block(net, 80, "5", drop=0.2)
        net = nn.max_pool(net, (2, 1), strides=(2, 1))
        net = conv_block(net, 128, "6", drop=0.2)
        net = conv_block(net, 144, "7", drop=0.2)
        net = jnp.squeeze(net, axis=1)  # (B, T, 144)

        for i in range(5):
            net = nn.Dropout(0.5, deterministic=not train)(net)
            fwd = nn.RNN(nn.OptimizedLSTMCell(256), name=f"lstm_fwd_{i}")
            bwd = nn.RNN(nn.OptimizedLSTMCell(256), reverse=True, keep_order=True,
                         name=f"lstm_bwd_{i}")
            net = jnp.concatenate([fwd(net), bwd(net)], axis=-1)

        net = nn.Dropout(0.5, deterministic=not train)(net)
        logits = nn.Dense(self.num_classes, dtype=self.dtype, name="frame_logits")(net)
        return logits.astype(jnp.float32)

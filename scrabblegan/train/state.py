"""Train state: parameters, BN/SN statistics, and optimizer states for all four
networks (G, D, R, W) as one pytree, plus the model builders.

Replaces the reference's Keras models + 4 Keras optimizers + vestigial
tf.train.Checkpoint (main.py:73-102, SURVEY.md component 22) with a single
dataclass pytree that train/checkpoint.py saves and restores atomically —
upgrading checkpoint/resume from vestigial to real (SURVEY.md §5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp
import optax

from scrabblegan.config import Config
from scrabblegan.models import (
    BiLSTMRecognizer,
    DCGANDiscriminator,
    Discriminator,
    Generator,
    Recognizer,
    StylePromoter,
)


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """The four networks (reference main.py:73-87)."""

    generator: Generator
    discriminator: Any
    recognizer: Any
    style_promoter: StylePromoter


@dataclasses.dataclass(frozen=True)
class TrainState:
    step: jnp.ndarray
    g_params: Any
    g_stats: Any
    d_params: Any
    d_stats: Any
    r_params: Any
    r_stats: Any
    w_params: Any
    w_stats: Any
    g_opt: Any
    d_opt: Any
    r_opt: Any
    w_opt: Any
    # EMA copy of g_params when optimizer.g_ema_decay > 0, else None (None is
    # an empty pytree, so EMA-off states keep the exact round-1 leaf set and
    # old checkpoints restore unchanged).
    g_ema: Any = None

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


jax.tree_util.register_dataclass(
    TrainState, data_fields=[f.name for f in dataclasses.fields(TrainState)],
    meta_fields=[])


def build_models(cfg: Config, use_pallas_attention: bool | None = None) -> ModelBundle:
    if cfg.shared.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"shared.dtype must be 'float32' or 'bfloat16', "
                         f"got {cfg.shared.dtype!r}")
    dtype = jnp.bfloat16 if cfg.shared.dtype == "bfloat16" else jnp.float32
    # BN-free trunks (D, W, G's style encoder) may run a different compute
    # dtype (config.SharedSpecs.trunk_dtype); param dtype is f32 either way.
    trunk = getattr(cfg.shared, "trunk_dtype", "") or cfg.shared.dtype
    if trunk not in ("float32", "bfloat16"):
        # ADVICE r4: a typo'd value ('bf16', 'float16') must not silently
        # train f32 while the config claims bf16
        raise ValueError(f"shared.trunk_dtype must be '', 'float32' or "
                         f"'bfloat16', got {cfg.shared.trunk_dtype!r}")
    trunk_dtype = jnp.bfloat16 if trunk == "bfloat16" else jnp.float32
    use_sn = cfg.shared.kernel_reg == "spectral_norm"
    h, _, c = cfg.io.input_dim
    if use_pallas_attention is None:
        use_pallas_attention = cfg.shared.use_pallas_attention

    generator = Generator(
        vocab_size=cfg.io.n_classes,
        latent_dim=cfg.shared.latent_dim,
        embed_y=cfg.shared.embed_y,
        blocks_with_attention=cfg.shared.g_bw_attention,
        z_source=cfg.shared.z_source,
        img_channels=c,
        img_height=h,
        use_sn=use_sn,
        use_pallas_attention=use_pallas_attention,
        conv_lowering=cfg.shared.conv_lowering,
        # 'padded' mode label-pads every word to one static length; the pad id
        # (== n_classes) gets its own filter-bank row
        num_pad_tokens=1 if cfg.parallel.shape_mode == "padded" else 0,
        dtype=dtype,
        style_encoder_dtype=trunk_dtype,
    )
    if cfg.shared.my_disc:
        discriminator = DCGANDiscriminator(use_sn=use_sn, dtype=trunk_dtype)
    else:
        discriminator = Discriminator(
            blocks_with_attention=cfg.shared.d_bw_attention,
            use_sn=use_sn,
            use_pallas_attention=use_pallas_attention,
            dtype=trunk_dtype,
        )
    rec_cls = BiLSTMRecognizer if cfg.shared.my_rec else Recognizer
    recognizer = rec_cls(num_classes=cfg.io.n_classes + 1, dtype=dtype)
    style_promoter = StylePromoter(
        blocks_with_attention=cfg.shared.d_bw_attention,
        use_sn=use_sn,
        use_pallas_attention=use_pallas_attention,
        dtype=trunk_dtype,
    )
    return ModelBundle(generator, discriminator, recognizer, style_promoter)


def make_optimizers(cfg: Config) -> Dict[str, optax.GradientTransformation]:
    """Adam x4 (lr 2e-4, betas (0.0, 0.999)); optional RMSprop for R
    (reference main.py:25-35, scrabble_gan.gin:5-14). LR schedule defaults to
    constant (reference parity); cosine / warmup+cosine available."""
    o = cfg.optimizer

    def schedule(lr):
        if o.lr_schedule == "constant":
            return lr
        if o.lr_schedule == "cosine":
            return optax.cosine_decay_schedule(lr, o.decay_steps)
        if o.lr_schedule == "warmup_cosine":
            return optax.warmup_cosine_decay_schedule(
                0.0, lr, o.warmup_steps, o.decay_steps)
        raise ValueError(f"unknown lr_schedule: {o.lr_schedule}")

    if o.adam_impl == "lean":
        from scrabblegan.train.optim import lean_adam

        adam = lambda lr: lean_adam(schedule(lr), b1=o.beta_1, b2=o.beta_2,
                                    moment_dtype=o.moment_dtype)
    elif o.adam_impl == "optax":
        adam = lambda lr: optax.adam(schedule(lr), b1=o.beta_1, b2=o.beta_2)
    else:
        raise ValueError(f"unknown adam_impl {o.adam_impl!r}")
    return {
        "g": adam(o.g_lr),
        "d": adam(o.d_lr),
        "r": optax.rmsprop(schedule(o.r_lr)) if o.rmsprop else adam(o.r_lr),
        "w": adam(o.w_lr),
    }


def _split_vars(variables):
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    return params, stats


def create_train_state(cfg: Config, rng: jax.Array,
                       models: ModelBundle | None = None) -> TrainState:
    models = models or build_models(cfg)
    h, w_max, c = cfg.io.input_dim
    batch = cfg.shared.batch_size
    init_len = 4  # any length works: all networks are fully conv over width
    k_g, k_d, k_r, k_w = jax.random.split(rng, 4)

    labels = jnp.zeros((batch, init_len), jnp.int32)
    imgs = jnp.zeros((batch, h, (h // 2) * init_len, c), jnp.float32)
    style_imgs = jnp.zeros((batch, h, w_max, c), jnp.float32)

    if cfg.shared.z_source == "style":
        g_vars = models.generator.init(k_g, labels, style_imgs=style_imgs, train=True)
    else:
        z = jnp.zeros((batch, cfg.shared.latent_dim), jnp.float32)
        g_vars = models.generator.init(k_g, labels, z=z, train=True)
    d_vars = models.discriminator.init(k_d, imgs, True)
    r_vars = models.recognizer.init({"params": k_r, "dropout": k_r}, imgs, True)
    w_vars = models.style_promoter.init(k_w, style_imgs, True)

    opts = make_optimizers(cfg)
    g_params, g_stats = _split_vars(g_vars)
    d_params, d_stats = _split_vars(d_vars)
    r_params, r_stats = _split_vars(r_vars)
    w_params, w_stats = _split_vars(w_vars)

    return TrainState(
        step=jnp.zeros((), jnp.int32),
        g_params=g_params, g_stats=g_stats,
        d_params=d_params, d_stats=d_stats,
        r_params=r_params, r_stats=r_stats,
        w_params=w_params, w_stats=w_stats,
        g_opt=opts["g"].init(g_params),
        d_opt=opts["d"].init(d_params),
        r_opt=opts["r"].init(r_params),
        w_opt=opts["w"].init(w_params),
        # EMA starts at the init weights (BigGAN convention)
        g_ema=(jax.tree.map(jnp.array, g_params)
               if cfg.optimizer.g_ema_decay > 0 else None),
    )


def param_count(tree) -> int:
    return sum(x.size for x in jax.tree_util.tree_leaves(tree))

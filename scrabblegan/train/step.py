"""The single jitted multi-network train step.

Replaces the reference's eager 4-GradientTape step (data_utils.py:355-473 — the
`@tf.function` there is commented out, so the reference runs per-op eager kernels)
with ONE traced/compiled function that:

1. runs all six forward passes (G composite -> D/W/R on fake; D on real; W on style
   + IAM; R on real) once,
2. computes all four losses with the gradient routing of the reference encoded as
   stop_gradient placement —
     - D/W/R gradients never flow into G's images (stop_gradient on gen_imgs for
       their own-loss passes),
     - G's gradients flow THROUGH frozen D/R/W (stop_gradient on those param trees,
       reference net_architecture.py:543-545),
     - R trains on real data only (gradients from the CTC-on-real term; the
       CTC-on-fake term only steers G — reference data_utils.py:454, SURVEY.md
       defect #5),
3. obtains all four per-network gradients in a SINGLE backward pass of the summed
   scalar loss (the cross-terms are exactly zero by construction), and
4. applies the four optax updates, gating G's update on the `disc_iters` cadence
   with lax.cond (reference data_utils.py:462-468).

XLA CSEs the duplicated frozen/unfrozen forward evaluations (identical forward
values, different backward graphs), so the compiled step does each forward once.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from scrabblegan.config import Config
from scrabblegan.ops.balance import balanced_fanout, gradient_balance
from scrabblegan.ops.ctc import ctc_loss
from scrabblegan.ops.losses import DISC_LOSS_REGISTRY, GEN_LOSS_REGISTRY
from scrabblegan.train.state import ModelBundle, TrainState, make_optimizers

# The 16 per-step statistics of the reference (train_step return,
# data_utils.py:470-473 / summary header :254-255).
METRIC_NAMES = (
    "d_loss", "d_loss_real", "d_loss_fake",
    "r_loss_real", "r_loss_fake", "r_loss_balanced",
    "g_loss", "g_loss_added", "g_loss_balanced", "g_loss_final",
    "alpha", "r_loss_fake_std", "g_loss_std",
    "s_loss", "s_loss_real", "s_loss_fake",
)

_sg = jax.lax.stop_gradient


def normalize_batch_images(batch: Dict[str, Any]) -> Dict[str, Any]:
    """uint8 wire format (parallel.transfer_dtype): image tensors may arrive as
    raw bytes; normalize to [-1, 1] on-device with exactly the host formula
    ((x - 127.5) / 127.5, loaders.py:121). XLA fuses this into the first conv.
    float32 inputs pass through untouched."""
    out = dict(batch)
    for k in ("real_imgs", "style_imgs"):
        v = out.get(k)
        if v is not None and jnp.issubdtype(v.dtype, jnp.integer):
            out[k] = (v.astype(jnp.float32) - 127.5) / 127.5
    return out


def make_train_step(cfg: Config, models: ModelBundle):
    """Returns step(state, batch, rng) -> (state, metrics dict of scalars).

    batch keys:
      real_imgs    (B, 32, 16*Lr, C) float32 in [-1, 1]
      real_labels  (B, Lr) int32
      style_imgs   (B, 32, 160, C) float32
      fake_labels  (B, Lf) int32
    Shapes are static per (Lr, Lf) pair; the caller jits one specialization per
    bucket (SURVEY.md §7 "per-bucket jit cache").
    """
    disc_loss_fn = DISC_LOSS_REGISTRY[cfg.optimizer.loss_fn]
    gen_loss_fn = GEN_LOSS_REGISTRY[cfg.optimizer.loss_fn]
    if cfg.optimizer.style_loss_mode not in (
            "adversarial", "style_vs_iam", "bug_compatible"):
        raise ValueError(
            f"unknown style_loss_mode {cfg.optimizer.style_loss_mode!r}")
    if cfg.optimizer.balance_mode not in ("loss_rescale", "grad_norm"):
        raise ValueError(
            f"unknown balance_mode {cfg.optimizer.balance_mode!r}")
    grad_norm_balance = (cfg.shared.use_recognizer
                        and cfg.optimizer.apply_gradient_balance
                        and cfg.optimizer.balance_mode == "grad_norm")
    opts = make_optimizers(cfg)
    o = cfg.optimizer
    my_rec = cfg.shared.my_rec
    z_source = cfg.shared.z_source
    latent_dim = cfg.shared.latent_dim
    padded = cfg.parallel.shape_mode == "padded"
    use_r = cfg.shared.use_recognizer
    use_w = cfg.shared.use_style_promoter

    G, D, R, W = (models.generator, models.discriminator, models.recognizer,
                  models.style_promoter)

    def forward_losses(trainable, state: TrainState, batch, rng):
        gp, dp, rp, wp = trainable
        real_imgs = batch["real_imgs"]
        real_labels = batch["real_labels"]
        style_imgs = batch["style_imgs"]
        fake_labels = batch["fake_labels"]
        bsz = fake_labels.shape[0]
        rng_noise, rng_drop = jax.random.split(rng)

        if padded:
            # 'padded' mode: every batch is one static max shape; true lengths
            # travel with the batch and drive width masks + CTC lengths
            real_lengths = batch["real_lengths"].astype(jnp.int32)
            fake_lengths = batch["fake_lengths"].astype(jnp.int32)
            feat_w_real = real_imgs.shape[2] // 8  # D/W trunk pools /2 three times
            cols_real = jnp.arange(feat_w_real)[None, :]
            mask_real = (cols_real < 2 * real_lengths[:, None]).astype(jnp.float32)
            feat_w_fake = feat_w_real  # gen canvas padded to the same max width
            mask_fake = (jnp.arange(feat_w_fake)[None, :]
                         < 2 * fake_lengths[:, None]).astype(jnp.float32)
        else:
            real_lengths = jnp.full((bsz,), real_labels.shape[1], jnp.int32)
            fake_lengths = jnp.full((bsz,), fake_labels.shape[1], jnp.int32)
            mask_real = mask_fake = None

        # --- G forward (own pass: keep mutated batch stats) ---
        def g_forward(g_params, g_stats, labels, cond, lengths):
            kw = {"style_imgs": cond} if z_source == "style" else {"z": cond}
            if lengths is not None:
                kw["lengths"] = lengths
            return G.apply({"params": g_params, "batch_stats": g_stats},
                           labels, train=True, mutable=["batch_stats"], **kw)

        if cfg.shared.remat:
            # rematerialize G's activations in the backward pass (memory lever)
            g_forward = jax.checkpoint(g_forward)
        cond = style_imgs if z_source == "style" else jax.random.normal(
            rng_noise, (bsz, latent_dim))
        gen_imgs, g_muts = g_forward(gp, state.g_stats, fake_labels, cond,
                                     fake_lengths if padded else None)

        # balance_mode='grad_norm': the G-view adversarial passes and the
        # CTC-on-fake pass read the generated images through separate branches
        # of a balancing fanout; values are identical, but the backward
        # combines the two image-cotangents per the paper's gradient-norm
        # formula instead of summing them (ops/balance.balanced_fanout)
        if grad_norm_balance:
            gen_for_adv, gen_for_ctc = balanced_fanout(gen_imgs,
                                                       o.balance_alpha)
        else:
            gen_for_adv = gen_for_ctc = gen_imgs

        # --- D passes ---
        d_vars = {"params": dp, "batch_stats": state.d_stats}
        d_real, d_muts = D.apply(d_vars, real_imgs, True, width_mask=mask_real,
                                 mutable=["batch_stats"])
        d_fake_for_d, _ = D.apply(d_vars, _sg(gen_imgs), True, width_mask=mask_fake,
                                  mutable=["batch_stats"])
        d_fake_for_g, _ = D.apply({"params": _sg(dp), "batch_stats": state.d_stats},
                                  gen_for_adv, True, width_mask=mask_fake,
                                  mutable=["batch_stats"])

        # --- W passes (skipped entirely under the G+D-only ablation) ---
        if use_w:
            w_vars = {"params": wp, "batch_stats": state.w_stats}
            s_style, w_muts = W.apply(w_vars, style_imgs, True,
                                      mutable=["batch_stats"])
            s_iam, _ = W.apply(w_vars, real_imgs, True, width_mask=mask_real,
                               mutable=["batch_stats"])
            s_gen_for_w, _ = W.apply(w_vars, _sg(gen_imgs), True,
                                     width_mask=mask_fake,
                                     mutable=["batch_stats"])
            s_fake_for_g, _ = W.apply(
                {"params": _sg(wp), "batch_stats": state.w_stats},
                gen_for_adv, True, width_mask=mask_fake,
                mutable=["batch_stats"])
        else:
            zeros = jnp.zeros((bsz,), jnp.float32)
            s_style = s_iam = s_gen_for_w = s_fake_for_g = zeros
            w_muts = {"batch_stats": state.w_stats}

        # --- R passes (CTC) ---
        r_vars = {"params": rp, "batch_stats": state.r_stats}
        # reference length algebra: input_length = 4*len - 1 for BOTH recognizer
        # variants (data_utils.py:400,413)
        inp_len_fake = 4 * fake_lengths - 1
        inp_len_real = 4 * real_lengths - 1
        lab_len_fake = fake_lengths
        lab_len_real = real_lengths

        if use_r:
            r_logits_fake, _ = R.apply(
                {"params": _sg(rp), "batch_stats": state.r_stats},
                gen_for_ctc, True, mutable=["batch_stats"],
                rngs={"dropout": rng_drop})
            r_fake = ctc_loss(r_logits_fake, fake_labels, inp_len_fake,
                              lab_len_fake)
            r_logits_real, r_muts = R.apply(r_vars, real_imgs, True,
                                            mutable=["batch_stats"],
                                            rngs={"dropout": rng_drop})
            r_real = ctc_loss(r_logits_real, real_labels, inp_len_real,
                              lab_len_real)
        else:  # adversarial-only ablation (BASELINE.json config 2)
            r_fake = r_real = jnp.zeros((bsz,), jnp.float32)
            r_muts = {"batch_stats": state.r_stats}

        # --- adversarial losses ---
        # Style-promoter wiring (config.OptimizerConfig.style_loss_mode for
        # the three modes and why 'style_vs_iam' diverges; SURVEY.md defect #2)
        mode = ("bug_compatible" if o.bug_compatible_style_loss
                else o.style_loss_mode)
        if mode == "bug_compatible":
            # reference call-site wiring: W trained style(1) vs GENERATED(0);
            # G's style term on IAM logits (zero grad — W is a spectator for G)
            s_neg, s_for_g = s_gen_for_w, _sg(s_iam)
        elif mode == "style_vs_iam":
            # literal reading of the reference's variable names; W never sees
            # G's outputs -> G exploits it unboundedly (see config docstring)
            s_neg, s_for_g = s_iam, s_fake_for_g
        else:  # 'adversarial': sound pairing — W tracks G, G gets live grads
            s_neg, s_for_g = s_gen_for_w, s_fake_for_g

        # D-update view (d_fake through D params, G frozen)
        d_loss, d_loss_real, d_loss_fake = disc_loss_fn(d_real, d_fake_for_d)
        # G-update view (d_fake/s_fake through G, D/W frozen)
        g_loss = gen_loss_fn(d_fake_for_g)
        if use_w:
            s_loss, s_loss_pos, s_loss_neg = disc_loss_fn(s_style, s_neg)
            g_loss = g_loss + gen_loss_fn(s_for_g)
        else:
            s_loss = s_loss_pos = s_loss_neg = jnp.zeros((bsz,), jnp.float32)

        # gradient balancing (data_utils.py:421-427,476-490)
        if grad_norm_balance:
            # 'grad_norm': the VALUE is the plain sum — the balancing lives in
            # balanced_fanout's backward (image-cotangent rescale). The scale
            # is a backward-only quantity; report the loss-space stds for
            # observability column parity.
            g_added = g_loss + r_fake
            g_balanced = g_final = g_added
            r_balanced = r_fake
            alpha = o.balance_alpha
            r_fake_std, g_loss_std = jnp.std(r_fake), jnp.std(g_loss)
        elif use_r:
            g_balanced, r_balanced, alpha, r_fake_std, g_loss_std = \
                gradient_balance(r_fake, g_loss, alpha=o.balance_alpha)
            g_added = g_loss + r_fake
            g_final = g_balanced if o.apply_gradient_balance else g_added
        else:
            g_balanced = r_balanced = jnp.zeros((bsz,), jnp.float32)
            alpha, r_fake_std, g_loss_std = 0.0, jnp.float32(0), jnp.float32(0)
            g_added = g_final = g_loss

        total = (jnp.mean(d_loss) + jnp.mean(s_loss) + jnp.mean(r_real)
                 + jnp.mean(g_final))

        metrics = {
            "d_loss": jnp.mean(d_loss),
            "d_loss_real": jnp.mean(d_loss_real),
            "d_loss_fake": jnp.mean(d_loss_fake),
            "r_loss_real": jnp.mean(r_real),
            "r_loss_fake": jnp.mean(r_fake),
            "r_loss_balanced": jnp.mean(r_balanced),
            "g_loss": jnp.mean(g_loss),
            "g_loss_added": jnp.mean(g_added),
            "g_loss_balanced": jnp.mean(g_balanced),
            "g_loss_final": jnp.mean(g_final),
            "alpha": jnp.asarray(alpha, jnp.float32),
            "r_loss_fake_std": r_fake_std,
            "g_loss_std": g_loss_std,
            "s_loss": jnp.mean(s_loss),
            "s_loss_real": jnp.mean(s_loss_pos),
            "s_loss_fake": jnp.mean(s_loss_neg),
        }
        muts = (g_muts["batch_stats"], d_muts.get("batch_stats", {}),
                r_muts.get("batch_stats", {}), w_muts.get("batch_stats", {}))
        return total, (metrics, muts)

    def step(state: TrainState, batch: Dict[str, Any], rng: jax.Array
             ) -> Tuple[TrainState, Dict[str, jnp.ndarray]]:
        batch = normalize_batch_images(batch)
        trainable = (state.g_params, state.d_params, state.r_params, state.w_params)
        grads, (metrics, muts) = jax.grad(forward_losses, has_aux=True)(
            trainable, state, batch, rng)
        g_grads, d_grads, r_grads, w_grads = grads
        g_stats, d_stats, r_stats, w_stats = muts

        d_updates, d_opt = opts["d"].update(d_grads, state.d_opt, state.d_params)
        d_params = jax.tree.map(lambda p, u: p + u, state.d_params, d_updates)
        r_updates, r_opt = opts["r"].update(r_grads, state.r_opt, state.r_params)
        r_params = jax.tree.map(lambda p, u: p + u, state.r_params, r_updates)
        w_updates, w_opt = opts["w"].update(w_grads, state.w_opt, state.w_params)
        w_params = jax.tree.map(lambda p, u: p + u, state.w_params, w_updates)

        # G updates every disc_iters-th step (data_utils.py:462); the EMA tree
        # (optimizer.g_ema_decay) advances on the same cadence
        ema_d = o.g_ema_decay

        def g_update(_):
            upd, new_opt = opts["g"].update(g_grads, state.g_opt, state.g_params)
            new_params = jax.tree.map(lambda p, u: p + u, state.g_params, upd)
            new_ema = (jax.tree.map(lambda e, p: ema_d * e + (1.0 - ema_d) * p,
                                    state.g_ema, new_params)
                       if ema_d > 0 else state.g_ema)
            return new_params, new_opt, new_ema

        def g_skip(_):
            return state.g_params, state.g_opt, state.g_ema

        if o.disc_iters == 1:
            # static fast path: the cadence is every step (the reference's gin
            # default, scrabble_gan.gin:11), and a lax.cond is not free — its
            # operand/result trees (all G params + Adam moments) are copied at
            # the branch boundary every step (profiler: ~1,600 tiny async
            # copies, ~2-3 ms of a 48 ms len-10 step)
            g_params, g_opt, g_ema = g_update(None)
        else:
            take_g_step = (state.step + 1) % o.disc_iters == 0
            g_params, g_opt, g_ema = jax.lax.cond(
                take_g_step, g_update, g_skip, None)

        new_state = state.replace(
            step=state.step + 1,
            g_params=g_params, g_stats=g_stats,
            d_params=d_params, d_stats=d_stats,
            r_params=r_params, r_stats=r_stats,
            w_params=w_params, w_stats=w_stats,
            g_opt=g_opt, d_opt=d_opt, r_opt=r_opt, w_opt=w_opt,
            g_ema=g_ema,
        )
        return new_state, metrics

    return step


def make_chunked_train_step(cfg: Config, models: ModelBundle):
    """K = cfg.parallel.steps_per_call train steps per device dispatch, via
    lax.scan over a stacked batch (leading axis K on every leaf) and K rngs.

    Amortizes per-call dispatch/fetch overhead. Semantically identical to K sequential steps (the
    disc_iters cadence rides the step counter inside the scan)."""
    step = make_train_step(cfg, models)

    def chunk(state: TrainState, batches, rngs):
        def body(st, xs):
            b, r = xs
            return step(st, b, r)

        return jax.lax.scan(body, state, (batches, rngs))

    return chunk

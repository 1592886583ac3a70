#!/usr/bin/env python
"""Quantify the padded-vs-narrow objective gap (VERDICT r3 item 2).

docs/PARITY.md row 17 claims padded mode + independent pairing reproduces the
reference's pairing SEMANTICS (length distributions, single static shape —
tests/test_pairing.py). What that claim does NOT cover is the per-sample
OBJECTIVE: the reference feeds D/W/R narrow single-width batches
(/root/reference/src/bigacgan/data_utils.py:406, net_architecture.py:323
w=None), while padded mode feeds white-padded canvases masked only at the
GAP (train/step.py width masks). Three mechanisms make the two presentations
of the SAME pixel content differ:

  1. boundary halos: conv windows near the 16*len content edge see white
     (+1.0) pixels instead of the narrow batch's zero SAME-padding, and the
     NonLocal attention (global over H*W tokens) mixes pad-region features
     into every position;
  2. BN batch statistics: G's CBN/final BN (and R's BN) reduce over the full
     padded width, so PAD columns shift the normalization of valid columns
     in train mode;
  3. PAD-seed halo: in padded mode G's filter bank emits PAD-row seeds for
     positions >= len whose influence re-enters the valid columns through
     the up-stack's receptive field and the B3 attention.

This script MEASURES all three on a TRAINED checkpoint (a padded-mode
campaign run, e.g. runs/quality/pmsk) with real data, at several word
lengths, and writes docs/quality/padded_gap.json. tests/test_padded_gap.py
pins the same machinery at init (exact equality at the L == L_max anchor +
an empirical bound); docs/PARITY.md carries the trained-run numbers.

Usage:
  JAX_PLATFORMS=cpu python scripts/padded_gap_study.py \
      --run runs/quality/pmsk --data runs/quality/data-skew-iam \
      [--lengths 2,5,8] [--batch 16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from scrabblegan.config import apply_overrides, discover_config, load_config
from scrabblegan.data.loaders import (
    BucketedDataset,
    load_random_word_list,
    load_style_images,
    sample_fake_labels,
)
from scrabblegan.ops.ctc import ctc_loss
from scrabblegan.train import checkpoint as ckpt_lib
from scrabblegan.train.state import build_models, create_train_state


def feature_mask(bsz: int, w_img: int, lengths: np.ndarray) -> jnp.ndarray:
    """The step's masked-GAP width mask (train/step.py:115-120): D/W trunk
    pools /2 three times, content occupies 2*len of the w_img//8 columns."""
    cols = jnp.arange(w_img // 8)[None, :]
    return (cols < 2 * jnp.asarray(lengths)[:, None]).astype(jnp.float32)


def pad_white(imgs: np.ndarray, w_max: int) -> np.ndarray:
    pad_w = w_max - imgs.shape[2]
    if pad_w <= 0:
        return imgs
    return np.pad(imgs, ((0, 0), (0, 0), (0, pad_w), (0, 0)),
                  constant_values=1.0)


def pad_ids(labels: np.ndarray, l_max: int, pad_id: int) -> np.ndarray:
    pad_l = l_max - labels.shape[1]
    if pad_l <= 0:
        return labels
    return np.pad(labels, ((0, 0), (0, pad_l)), constant_values=pad_id)


def bn_leaf_paths(tree):
    """(path, leaf) pairs for BatchNorm mean/var leaves (excludes SN power
    vectors, which also live in batch_stats)."""
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [getattr(p, "key", str(p)) for p in path]
        if names[-1] in ("mean", "var"):
            out.append(("/".join(names), np.asarray(leaf)))
    return out


def rel_drift(tree_a, tree_b):
    """max/mean relative L2 drift across BN mean/var leaves of two mutated
    batch_stats trees."""
    rows = []
    for (name_a, a), (_, b) in zip(bn_leaf_paths(tree_a), bn_leaf_paths(tree_b)):
        denom = float(np.linalg.norm(b)) + 1e-8
        rows.append((name_a, float(np.linalg.norm(a - b)) / denom))
    vals = [v for _, v in rows]
    worst = max(rows, key=lambda r: r[1])
    return {"bn_rel_drift_max": worst[1], "bn_rel_drift_max_leaf": worst[0],
            "bn_rel_drift_mean": float(np.mean(vals))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", default="runs/quality/pmsk")
    p.add_argument("--data", default="runs/quality/data-skew-iam")
    p.add_argument("--lengths", default="2,5,8")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--out", default="docs/quality/padded_gap.json")
    args = p.parse_args(argv)

    cfg_path = discover_config(args.run)
    assert cfg_path, f"no config.json under {args.run}"
    cfg = load_config(cfg_path)
    assert cfg.parallel.shape_mode == "padded", "need a padded-mode run"
    print(f"config: {cfg_path}  backend: {jax.default_backend()}", flush=True)

    models_p = build_models(cfg, use_pallas_attention=False)
    state = create_train_state(cfg, jax.random.PRNGKey(cfg.seed), models_p)
    ckpt_dir = os.path.join(args.run, cfg.io.checkpoint_dir)
    state, step = ckpt_lib.restore_state(ckpt_dir, state)
    assert state is not None, f"no checkpoint under {ckpt_dir}"
    print(f"restored step {step}", flush=True)

    cfg_n = apply_overrides(cfg, {"parallel.shape_mode": "bucketed"})
    models_n = build_models(cfg_n, use_pallas_attention=False)
    # narrow G = padded G minus the filter bank's PAD row
    gp_n = jax.tree.map(lambda x: x, state.g_params)  # shallow copy
    gp_n["filter_bank"] = {
        "filter_bank": state.g_params["filter_bank"]["filter_bank"][:cfg.io.n_classes]}

    h, w_max, c = cfg.io.input_dim
    l_max = cfg.io.bucket_size
    pad_id = cfg.io.n_classes
    ds = BucketedDataset(os.path.join(args.data, "words-Reading"),
                         cfg.io.input_dim, l_max, cfg.io.char_vec, seed=7)
    style_train, _ = load_style_images(os.path.join(args.data, "style_imgs"),
                                       cfg.io.input_dim, seed=7)
    words = load_random_word_list(os.path.join(args.data, "random_words.txt"),
                                  l_max, cfg.io.char_vec)
    rng = np.random.default_rng(11)

    D, W, R, G_p, G_n = (models_p.discriminator, models_p.style_promoter,
                         models_p.recognizer, models_p.generator,
                         models_n.generator)
    d_vars = {"params": state.d_params, "batch_stats": state.d_stats}
    w_vars = {"params": state.w_params, "batch_stats": state.w_stats}
    r_vars = {"params": state.r_params, "batch_stats": state.r_stats}
    gv_p = {"params": state.g_params, "batch_stats": state.g_stats}
    gv_n = {"params": gp_n, "batch_stats": state.g_stats}

    jd = jax.jit(lambda v, x, m: D.apply(v, x, False, width_mask=m))
    jw = jax.jit(lambda v, x, m: W.apply(v, x, False, width_mask=m))
    jr = jax.jit(lambda v, x: R.apply(v, x, False))
    # `train` must be trace-static (SN/BN branch on it in Python)
    jg_p = jax.jit(lambda v, lab, sty, ln, train: G_p.apply(
        v, lab, style_imgs=sty, lengths=ln, train=train,
        mutable=["batch_stats"]), static_argnums=(4,))
    jg_n = jax.jit(lambda v, lab, sty, train: G_n.apply(
        v, lab, style_imgs=sty, train=train, mutable=["batch_stats"]),
        static_argnums=(3,))

    results = []
    for L in [int(x) for x in args.lengths.split(",")] + [l_max]:
        bsz = args.batch
        imgs_n, labels_n, _ = ds.sample_batch(bsz, bucket=L)
        imgs_p = pad_white(imgs_n, w_max)
        labels_p = pad_ids(labels_n, l_max, pad_id)
        lengths = np.full((bsz,), L, np.int32)
        mask = feature_mask(bsz, w_max, lengths)
        sty_idx = rng.integers(0, len(style_train), size=bsz)
        sty = np.stack([style_train[i] for i in sty_idx])[..., None].astype(np.float32)

        row = {"len": L, "step": step, "batch": bsz}

        # ---- D / W logits: same content, two presentations -------------
        for name, fn, v in (("d", jd, d_vars), ("w", jw, w_vars)):
            lo_n = np.asarray(fn(v, imgs_n, None))
            lo_p = np.asarray(fn(v, imgs_p, mask))
            delta = np.abs(lo_p - lo_n)
            row[f"{name}_logit_mean_abs_delta"] = float(delta.mean())
            row[f"{name}_logit_max_abs_delta"] = float(delta.max())
            row[f"{name}_logit_std_narrow"] = float(lo_n.std())
            # hinge-objective delta on the same logits vs the margin (=1)
            row[f"{name}_hinge_real_delta"] = float(np.abs(
                np.maximum(0, 1 - lo_p) - np.maximum(0, 1 - lo_n)).mean())

        # ---- R: CTC loss + frame logits over the valid frames ----------
        t_valid = 4 * L - 1
        lg_n = np.asarray(jr(r_vars, imgs_n))          # (B, 4L-1, 53)
        lg_p = np.asarray(jr(r_vars, imgs_p))          # (B, 4*l_max-1, 53)
        row["r_frame_logit_max_abs_delta"] = float(
            np.abs(lg_p[:, :t_valid] - lg_n[:, :t_valid]).max())
        inp_len = np.full((bsz,), t_valid, np.int32)
        lab_len = np.full((bsz,), L, np.int32)
        ctc_n = np.asarray(ctc_loss(jnp.asarray(lg_n), jnp.asarray(labels_n),
                                    jnp.asarray(inp_len), jnp.asarray(lab_len)))
        ctc_p = np.asarray(ctc_loss(jnp.asarray(lg_p[:, :t_valid]),
                                    jnp.asarray(labels_p[:, :L]),
                                    jnp.asarray(inp_len), jnp.asarray(lab_len)))
        row["ctc_mean_narrow"] = float(ctc_n.mean())
        row["ctc_mean_abs_delta"] = float(np.abs(ctc_p - ctc_n).mean())

        # ---- G: PAD-seed halo on the valid columns ----------------------
        fake = sample_fake_labels(rng, words, bsz, L)
        fake_p = pad_ids(fake, l_max, pad_id)
        for mode, train in (("eval", False), ("train", True)):
            out_n, muts_n = jg_n(gv_n, fake, sty, train)
            out_p, muts_p = jg_p(gv_p, fake_p, sty, lengths, train)
            out_n = np.asarray(out_n)
            val_p = np.asarray(out_p)[:, :, :16 * L]
            col_delta = np.abs(val_p - out_n).max(axis=(0, 1, 3))  # per column
            row[f"g_{mode}_halo_max"] = float(col_delta.max())
            row[f"g_{mode}_halo_mean"] = float(np.abs(val_p - out_n).mean())
            # boundary = last 32 px of content (2 seed cols); interior = rest
            if 16 * L > 32:
                row[f"g_{mode}_halo_boundary_max"] = float(col_delta[-32:].max())
                row[f"g_{mode}_halo_interior_max"] = float(col_delta[:-32].max())
            if train:
                row.update(rel_drift(muts_p["batch_stats"],
                                     muts_n["batch_stats"]))

        results.append(row)
        print(json.dumps(row), flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        for row in results:
            f.write(json.dumps(row) + "\n")
    print(f"wrote {args.out}", flush=True)

    anchor = results[-1]
    print("\nSummary (trained step {}):".format(step))
    print(f"  anchor L={l_max} (degenerate: padded == narrow exactly): "
          f"d_delta={anchor['d_logit_max_abs_delta']:.2e}, "
          f"g_eval_halo={anchor['g_eval_halo_max']:.2e}")
    for row in results[:-1]:
        print(f"  L={row['len']}: |dD|mean={row['d_logit_mean_abs_delta']:.3f} "
              f"(logit std {row['d_logit_std_narrow']:.3f}), "
              f"CTC delta={row['ctc_mean_abs_delta']:.4f} "
              f"(CTC {row['ctc_mean_narrow']:.3f}), "
              f"G halo eval/train max={row['g_eval_halo_max']:.3f}/"
              f"{row['g_train_halo_max']:.3f}, "
              f"BN drift max={row['bn_rel_drift_max']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python
"""Quality/convergence campaign driver (VERDICT r1 item 1).

Trains a run to completion on a scaled-up synthetic dataset (the IAM stand-in;
no dataset download is possible in this environment), then scores EVERY
epoch's saved generator export post-hoc:

- rFID: Frechet distance over the FINAL recognizer's pooled conv features —
  the extractor is frozen across epochs so the curve is comparable.
- cer_gen: character error rate of the final recognizer reading each epoch's
  generated images against their intended labels (ScrabbleGAN's native
  "readability" signal).
- cer_real: CER of the final recognizer on real data (once per run; shows R
  itself learned, the precondition for trusting rFID/cer_gen).

Results land in <workdir>/quality.jsonl + an rFID/CER curve PNG; the epoch
grids the loop already dumps are the qualitative evidence
(reference bar: /root/reference/README.md:5-7, doc/ScrabbleGan_no_grad_bal.gif).

Runs (all 10 epochs x 2500 steps, batch 16, unless overridden):
  c4m       default config: style z, bucketed, matched pairing, hinge
  c3        configs/3: noise z, padded shape mode, gradient balancing
  pm        padded + matched pairing (style z) — single-compile baseline arm
  pi        padded + INDEPENDENT pairing (reference fake-bucket semantics,
            data_utils.py:385-387) — A/B vs pm for pairing dynamics
  bugstyle  pm + bug_compatible style wiring (reference defect #2 A/B: W
            trains style-vs-generated but G gets zero style gradient)

All arms otherwise use style_loss_mode='adversarial' (the sound pairing). The
naive 'style_vs_iam' reading was run once and DIVERGED (G exploits a W that
never sees generated images; NaN at ~16k steps) — evidence preserved in
docs/quality/style_vs_iam_divergence.tsv; it is not re-run.

The pairing and style-loss A/Bs run in 'padded' shape mode deliberately: one
XLA compilation per arm instead of up to 100 (real,fake) bucket-pair
specializations on the bucketed path — identical semantics, tractable compile
budget.

Usage:
  python scripts/quality_campaign.py --run c4m [--root runs/quality]
      [--epochs 10] [--batches-per-epoch 2500] [--eval-samples 512]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


RUNS = {
    "c4m": {},
    "c3": {"shared.z_source": "noise", "parallel.shape_mode": "padded",
           "optimizer.apply_gradient_balance": True},
    # c3 with the PAPER's gradient balancing instead of the reference's
    # loss rescaling (optimizer.balance_mode docstring) — A/B for the
    # loss_rescale CTC-weight collapse under a saturated D
    "c3g": {"shared.z_source": "noise", "parallel.shape_mode": "padded",
            "optimizer.apply_gradient_balance": True,
            "optimizer.balance_mode": "grad_norm"},
    # c4m (the bucketed default) trained 1 epoch then collapsed under D
    # domination (docs/QUALITY.md); c4g tests the grad_norm rescue (the c3->
    # c3g fix) in the bucketed arm — matched pairing keeps it at 10 compiles
    "c4g": {"optimizer.apply_gradient_balance": True,
            "optimizer.balance_mode": "grad_norm"},
    # c4g falsified the G-side hypothesis (grad_norm doesn't rescue the
    # bucketed regime); c4t tests the D-side one — TTUR with D and W at a
    # quarter of G's learning rate so D can't win the per-width game
    "c4t": {"optimizer.d_lr": 5e-5, "optimizer.w_lr": 5e-5},
    "pm": {"parallel.shape_mode": "padded",
           "parallel.bucket_pairing": "matched"},
    # pm under the bfloat16 compute policy (params stay f32) — the A/B that
    # licenses reporting bf16 train throughput as a supported configuration
    "pmbf16": {"parallel.shape_mode": "padded",
               "parallel.bucket_pairing": "matched",
               "shared.dtype": "bfloat16"},
    "pi": {"parallel.shape_mode": "padded",
           "parallel.bucket_pairing": "independent"},
    # pm + generator weight EMA (BigGAN arXiv:1809.11096 §3; decay 0.999
    # suits the 25k-step schedule — 0.9999 would still be ~8%-initialized at
    # the end). The per-epoch export and grids serve the EMA weights, so
    # quality.jsonl scores the EMA generator directly — A/B vs pm
    "pmema": {"parallel.shape_mode": "padded",
              "parallel.bucket_pairing": "matched",
              "optimizer.g_ema_decay": 0.999},
    "bugstyle": {"parallel.shape_mode": "padded",
                 "parallel.bucket_pairing": "matched",
                 "optimizer.bug_compatible_style_loss": True},
    # ---- bucketed-instability study, remaining cells (docs/QUALITY.md) ----
    # c4m on IAM-like length-skewed data: does the natural population skew
    # (short words dominate -> D sees a few widths most of the time) change
    # the bucketed-regime collapse?
    "c4sk": {},
    # padded control on the same skewed data (isolates data-vs-regime)
    "pmsk": {"parallel.shape_mode": "padded",
             "parallel.bucket_pairing": "matched"},
    # mixed-width batches: per-SAMPLE independent length draws inside each
    # padded batch (parallel.batch_mix='sample') — D never gets a
    # single-width batch to specialize against; A/B vs pm
    "pmmix": {"parallel.shape_mode": "padded",
              "parallel.bucket_pairing": "matched",
              "parallel.batch_mix": "sample"},
    # the recommended regime (configs/recommended.json) + trunk_dtype bf16
    # (BN-free D/W/StyleEncoder trunks in bf16) — the no-regression gate for making trunk-bf16 the throughput
    # default; A/B vs pmema (same regime, f32 trunks)
    "pmtb": {"parallel.shape_mode": "padded",
             "parallel.bucket_pairing": "matched",
             "optimizer.g_ema_decay": 0.999,
             "shared.trunk_dtype": "bfloat16"},
    # Reference-schedule stretch run (VERDICT r4 item 10): the reference's
    # FULL schedule — 10 epochs x 5,024 steps, batch 16 (scrabble_gan.gin:
    # 17-18, data_utils.py:239) — under the recommended regime on the
    # IAM-length-skewed synthetic substrate; the closest available analog of
    # the reference's 10-epoch qualitative bar (README:5-7) until real IAM
    # data exists. Drive with --batches-per-epoch 5024.
    "fullsched": {"parallel.shape_mode": "padded",
                  "parallel.bucket_pairing": "matched",
                  "optimizer.g_ema_decay": 0.999,
                  "shared.trunk_dtype": "bfloat16"},
}

# Arms that train on the length-skewed variant of the synthetic dataset
# (data.synthetic.IAM_LENGTH_WEIGHTS); everyone else shares the uniform one.
DATA_SKEW = {"c4sk": "iam", "pmsk": "iam", "fullsched": "iam"}

EVAL_BUCKET = 5  # default word length for rFID/CER batches
# Variable width is the reference's core capability
# (/root/reference/src/dinterface/iam_handwriting_db.py:73-80); scoring one
# bucket leaves length-generalization unmeasured (VERDICT r3 item 5) —
# --eval-buckets all sweeps every bucket per epoch.


def ensure_dataset(root: str, samples_per_bucket: int, seed: int = 7,
                   style: str = "script", skew: str | None = None):
    """Scaled synthetic dataset shared by all runs (10 buckets). skew='iam'
    builds/uses the length-skewed variant in its own directory."""
    from scrabblegan.data.synthetic import make_synthetic_dataset

    data_root = os.path.join(root, "data" if skew is None else f"data-skew-{skew}")
    read_dir = os.path.join(data_root, "words-Reading")
    # uniform data: bucket 5 holds samples_per_bucket; skewed: totals differ,
    # so compare against the computed population for bucket 5
    from scrabblegan.data.synthetic import bucket_populations

    want5 = bucket_populations(samples_per_bucket, 10, skew)[4]
    if os.path.isdir(read_dir) and os.path.isdir(os.path.join(read_dir, "10")):
        n = len([f for f in os.listdir(os.path.join(read_dir, "5"))
                 if f.endswith(".png")])
        if n >= want5:
            return (read_dir, os.path.join(data_root, "random_words.txt"),
                    os.path.join(data_root, "style_imgs"))
    print(f"building synthetic dataset ({samples_per_bucket}/bucket, "
          f"style={style}, skew={skew})...", flush=True)
    return make_synthetic_dataset(data_root,
                                  samples_per_bucket=samples_per_bucket,
                                  bucket_size=10, seed=seed, style=style,
                                  length_weights=skew)


def make_jit_generate(trainer):
    """Jitted inference-mode G apply — un-jitted Module.apply dispatches
    op-by-op; one jit makes each eval forward a single dispatch."""
    import jax

    cfg = trainer.cfg
    if cfg.shared.z_source == "style":
        return jax.jit(lambda v, labels, cond: trainer.models.generator.apply(
            v, labels, train=False, style_imgs=cond))
    return jax.jit(lambda v, labels, cond: trainer.models.generator.apply(
        v, labels, train=False, z=cond))


def generate_batched(jit_gen, cfg, variables, labels, style_imgs, z, chunk=64):
    """Inference-mode generation through an epoch's exported G variables."""
    outs = []
    for i in range(0, len(labels), chunk):
        cond = (style_imgs[i:i + chunk] if cfg.shared.z_source == "style"
                else z[i:i + chunk])
        out = jit_gen(variables, labels[i:i + chunk], cond)
        outs.append(np.asarray(out, np.float32))
    return np.concatenate(outs, 0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run", required=True, choices=sorted(RUNS))
    p.add_argument("--root", default="runs/quality")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batches-per-epoch", type=int, default=2500)
    p.add_argument("--eval-samples", type=int, default=512)
    p.add_argument("--samples-per-bucket", type=int, default=800)
    p.add_argument("--data-style", default="script",
                   choices=("stripes", "script"),
                   help="synthetic rendering: 'script' = Bezier "
                        "pseudo-handwriting with per-sample variation")
    p.add_argument("--eval-only", action="store_true",
                   help="skip training; re-score existing epoch exports")
    p.add_argument("--eval-buckets", default=str(EVAL_BUCKET),
                   help="comma-separated word lengths to score per epoch, or "
                        "'all' for every bucket 1..bucket_size (one "
                        "quality.jsonl row per (epoch, bucket))")
    p.add_argument("--eval-epochs", default=None,
                   help="restrict scoring to these epochs: comma list or "
                        "'last' (default: every available export). A full "
                        "bucket sweep costs a compile per bucket, so "
                        "'last' + --eval-buckets all is the cheap "
                        "length-generalization pass")
    args = p.parse_args(argv)

    import faulthandler
    import signal

    # `kill -USR1 <pid>` dumps all Python thread stacks to stderr without
    # killing the run — the non-destructive way to see where a stalled run
    # waits
    faulthandler.register(signal.SIGUSR1)

    import jax

    from scrabblegan.config import load_config
    from scrabblegan.data.loaders import sample_fake_labels
    from scrabblegan.eval import (
        character_error_rate,
        compute_rfid,
        greedy_ctc_decode,
        random_features,
        recognizer_features,
    )
    from scrabblegan.train import checkpoint as ckpt_lib
    from scrabblegan.train.loop import Trainer
    from scrabblegan.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    print(f"backend: {jax.default_backend()}", flush=True)

    overrides = dict(RUNS[args.run])
    # full-state checkpoints are a multi-GB device->host fetch per save;
    # the per-epoch G-only export (what the eval scores) stays at 1.
    # Every 3 epochs bounds the rework after a watchdog restart
    # (run_campaign.sh) to <3 epochs while keeping the fetch overhead ~10%.
    overrides.setdefault("io.ckpt_every", 3)
    # in-process stall self-heal (exit 86 -> run_campaign.sh retries +
    # resumes); 900s > the slowest observed legitimate block (cold padded
    # 4-network compile, full-state checkpoint fetch)
    overrides.setdefault("io.stall_timeout_s", 900)
    cfg = load_config(None, overrides)
    workdir = os.path.join(args.root, args.run)
    read_dir, words_file, style_dir = ensure_dataset(
        args.root, args.samples_per_bucket, style=args.data_style,
        skew=DATA_SKEW.get(args.run))

    trainer = Trainer(cfg, workdir=workdir)
    trainer.load_data(read_dir=read_dir, style_dir=style_dir,
                      words_file=words_file)

    # ------------------------------------------------------------------ train
    t0 = time.time()
    if not args.eval_only:
        trainer.train(epochs=args.epochs,
                      batches_per_epoch=args.batches_per_epoch, resume=True)
    train_secs = time.time() - t0

    # ------------------------------------------------------------- post-hoc eval
    # The trainer's watchdog stops when train() returns, but the eval phase
    # below still runs under run_campaign.sh's file-activity window and has
    # its own cold compiles (jit_gen / jit_rec / rFID extractor) that write
    # nothing to the workdir — keep a heartbeat alive and announce the
    # compile-bound firsts, exactly like the training loop does.
    from scrabblegan.utils.watchdog import StallWatchdog

    wd = None
    if cfg.io.stall_timeout_s:
        wd = StallWatchdog(cfg.io.stall_timeout_s, label="eval",
                           touch_file=os.path.join(workdir, ".heartbeat")).start()
        # the stretch from here to the first fixture beat includes the
        # full-state restore fetch, the (possibly cold) CPU init compiles,
        # and the state H2D — all progress-free; without this grace an
        # --eval-only run dies at exactly stall_timeout_s (observed: pmsk
        # re-sweep, 2026-08-20)
        wd.grace(cfg.io.compile_grace_s)

    def _grace():  # before each first-use jit compile in the eval phase
        if wd:
            wd.grace(cfg.io.compile_grace_s)

    def _beat():
        if wd:
            wd.beat()

    state = trainer.init_state(resume=True)
    total_steps = int(jax.device_get(state.step))
    extractor = recognizer_features(trainer.models.recognizer,
                                    state.r_params, state.r_stats)
    # second, run-independent Fréchet axis (fixed-seed random conv net):
    # agreement with rFID is evidence the trend isn't an artifact of the
    # run's own recognizer features (eval/fid.py random_features docstring)
    rand_extractor = random_features(seed=0)

    if args.eval_buckets == "all":
        buckets = sorted(trainer.dataset.nonempty)
    else:
        buckets = [int(b) for b in args.eval_buckets.split(",")]

    n = args.eval_samples
    rng = np.random.default_rng(123)
    rec = trainer.models.recognizer
    rec_vars = {"params": state.r_params, "batch_stats": state.r_stats}
    jit_rec = jax.jit(lambda v, imgs: rec.apply(v, imgs, train=False))
    jit_gen = make_jit_generate(trainer)

    def rec_cer(imgs, want_rows, bucket):
        """Greedy-decode CER of the final R on a (n, 32, 16*bucket, 1) stack."""
        logits = np.concatenate([
            np.asarray(jit_rec(rec_vars, imgs[i:i + 64]))
            for i in range(0, len(imgs), 64)])
        preds = greedy_ctc_decode(
            logits, np.full((len(imgs),), 4 * bucket - 1, np.int32))
        return character_error_rate(preds, want_rows)

    # per-bucket eval fixtures: real stacks + fixed fake labels/style/z, and
    # the per-bucket CER of the final recognizer on REAL data (constant per
    # run — the floor that licenses rFID/cer_gen)
    fixtures = {}
    for bucket in buckets:
        real_imgs, real_lab = [], []
        while sum(len(x) for x in real_imgs) < n:
            imgs, labs, _ = trainer.dataset.sample_batch(64, bucket=bucket)
            real_imgs.append(imgs)
            real_lab.append(labs)
        real_imgs = np.concatenate(real_imgs)[:n]
        real_lab = np.concatenate(real_lab)[:n]
        eval_labels = sample_fake_labels(rng, trainer.random_words, n, bucket)
        style_idx = rng.integers(0, len(trainer.style_train), size=n)
        eval_style = np.stack(
            [trainer.style_train[i] for i in style_idx])[..., None]
        eval_style = eval_style.astype(np.float32)
        eval_z = rng.standard_normal((n, cfg.shared.latent_dim)).astype(np.float32)
        _grace()  # first jit_rec dispatch per width compiles cold
        cer_real = rec_cer(real_imgs, [list(l) for l in real_lab], bucket)
        _beat()
        print(f"cer_real bucket {bucket}: {cer_real:.4f}", flush=True)
        fixtures[bucket] = (real_imgs, eval_labels, eval_style, eval_z, cer_real)

    gen_root = os.path.join(trainer.model_path, "generator")
    epochs_avail = sorted(int(d) for d in os.listdir(gen_root) if d.isdigit())
    if args.eval_epochs == "last":
        epochs_avail = epochs_avail[-1:]
    elif args.eval_epochs:
        want = {int(e) for e in args.eval_epochs.split(",")}
        epochs_avail = [e for e in epochs_avail if e in want]
    rows = []
    # an epoch-restricted re-score must not clobber the full epoch-curve
    # evidence: it lands in quality_sweep.jsonl and collect_quality.py merges
    out_name = "quality_sweep.jsonl" if args.eval_epochs else "quality.jsonl"
    out_jsonl = os.path.join(workdir, out_name)
    with open(out_jsonl, "w") as f:
        for ep in epochs_avail:
            variables = ckpt_lib.load_generator(os.path.join(gen_root, str(ep)))
            for bucket in buckets:
                real_imgs, eval_labels, eval_style, eval_z, cer_real = \
                    fixtures[bucket]
                if ep == epochs_avail[0]:
                    _grace()  # first jit_gen + extractor compiles per width
                gen = generate_batched(jit_gen, cfg, variables, eval_labels,
                                       eval_style, eval_z)
                rfid = compute_rfid(gen, real_imgs, extractor, batch_size=64)
                rfid_rand = compute_rfid(gen, real_imgs, rand_extractor,
                                         batch_size=64)
                # decode returns char IDS; compare ids-to-ids (eval_labels
                # are already encoded rows)
                want = [list(map(int, row)) for row in eval_labels]
                cer_gen = rec_cer(gen, want, bucket)
                row = {"run": args.run, "epoch": ep, "rfid": round(rfid, 4),
                       "rfid_rand": round(rfid_rand, 4),
                       "cer_gen": round(cer_gen, 4),
                       "cer_real": round(cer_real, 4),
                       "num_samples": n, "bucket": bucket,
                       "total_steps": total_steps,
                       "train_secs": round(train_secs, 1)}
                rows.append(row)
                f.write(json.dumps(row) + "\n")
                f.flush()
                _beat()
                print(json.dumps(row), flush=True)

    if wd:
        wd.stop()

    # ------------------------------------------------------------------ curve
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax1 = plt.subplots(figsize=(7, 4))
        # multi-bucket sweeps: one rFID line per bucket; the CER axis tracks
        # the default (or middlemost) bucket to keep the plot readable
        cer_bucket = EVAL_BUCKET if EVAL_BUCKET in buckets else \
            buckets[len(buckets) // 2]
        for bucket in buckets:
            brows = [r for r in rows if r["bucket"] == bucket]
            ax1.plot([r["epoch"] for r in brows], [r["rfid"] for r in brows],
                     "o-", alpha=0.9 if bucket == cer_bucket else 0.45,
                     label=f"rFID L={bucket}" if len(buckets) > 1 else "rFID")
        ax1.set_xlabel("epoch")
        ax1.set_ylabel("rFID (final-R features)")
        ax1.set_yscale("log")
        ax2 = ax1.twinx()
        crows = [r for r in rows if r["bucket"] == cer_bucket]
        cer_real = fixtures[cer_bucket][4]
        ax2.plot([r["epoch"] for r in crows], [r["cer_gen"] for r in crows],
                 "s--", color="#d62728",
                 label=f"CER on generated (L={cer_bucket})")
        ax2.axhline(cer_real, color="#2ca02c", lw=1, ls=":",
                    label=f"CER on real = {cer_real:.3f}")
        ax2.set_ylabel("CER", color="#d62728")
        ax2.set_ylim(0, 1.05)
        lines = ax1.get_lines() + ax2.get_lines()
        ax1.legend(lines, [l.get_label() for l in lines], loc="upper right",
                   fontsize=8)
        ax1.set_title(f"quality campaign: {args.run}")
        fig.tight_layout()
        out_png = os.path.join(workdir, "quality_curve.png")
        fig.savefig(out_png, dpi=120)
        print(f"wrote {out_png}", flush=True)
    except Exception as e:  # curve is a nicety; numbers are the deliverable
        print(f"curve plot failed: {e}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

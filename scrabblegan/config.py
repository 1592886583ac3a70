"""Typed configuration tree for scrabblegan.

Mirrors the three gin groups of the reference (`src/scrabble_gan.gin`,
`src/main.py:25-51`: setup_optimizer / shared_specs / io) as frozen dataclasses, with
JSON-file loading and dotted-path CLI overrides replacing gin. Loss functions and
kernel regularizers are selected by registry name, preserving the reference's
"swap @hinge / @not_saturating in config" capability (`src/main.py:16-18`).
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

CHAR_VECTOR = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


@dataclass(frozen=True)
class OptimizerConfig:
    """Reference: setup_optimizer gin bindings (scrabble_gan.gin:5-14)."""

    g_lr: float = 2e-4
    d_lr: float = 2e-4
    r_lr: float = 2e-4
    w_lr: float = 2e-4
    beta_1: float = 0.0
    beta_2: float = 0.999
    loss_fn: str = "hinge"  # registry name: 'hinge' | 'not_saturating'
    disc_iters: int = 1
    apply_gradient_balance: bool = False
    balance_alpha: float = 1.0
    # How the CTC-on-fake term is balanced against the adversarial G-loss when
    # apply_gradient_balance is on:
    #   'loss_rescale': the REFERENCE's formulation (data_utils.py:476-490) —
    #       rescale the CTC loss by std(g_loss)/std(r_fake). Fragile: a
    #       saturated D collapses std(g_loss) and with it the CTC weight
    #       (measured, docs/QUALITY.md).
    #   'grad_norm': the PAPER's formulation (arXiv:2003.10557) — rescale the
    #       CTC gradient w.r.t. the generated IMAGE to match the adversarial
    #       image-gradient's std (ops/balance.balanced_fanout custom VJP).
    balance_mode: str = "loss_rescale"
    rmsprop: bool = False  # RMSprop for the recognizer (reference main.py:29-32)
    # LR schedule: 'constant' (reference parity) | 'cosine' | 'warmup_cosine'.
    lr_schedule: str = "constant"
    warmup_steps: int = 1000
    decay_steps: int = 50240  # reference total: 10 epochs x 5024 steps
    # Style-promoter (W) objective wiring. The reference's call site and its
    # variable names disagree (SURVEY.md defect #2), and the two readings have
    # very different dynamics — measured in the round-2 quality campaign:
    #   'adversarial' (default): W trains style-imgs(1) vs GENERATED(0); G
    #       maximizes W(G(z)). A sound GAN pairing: W tracks whatever G
    #       produces, so G must move toward the style distribution.
    #   'style_vs_iam': the literal reading of the reference's variable names —
    #       W trains style(1) vs IAM(0) and never sees G's outputs. UNSOUND:
    #       G drives W's logit on generated images unboundedly positive
    #       (off-manifold exploit) -> logit runaway -> NaN (observed at ~16k
    #       steps, docs/QUALITY.md).
    #   'bug_compatible': the reference call-site wiring (data_utils.py:418
    #       vs :409-410): W trains style(1) vs generated(0), but G's style
    #       term is computed on IAM logits — constant w.r.t. G, so G gets
    #       ZERO style gradient (W is a spectator for G).
    style_loss_mode: str = "adversarial"
    # Deprecated alias: True forces style_loss_mode='bug_compatible'.
    bug_compatible_style_loss: bool = False
    # Exponential moving average of the generator weights (BigGAN's standard
    # serving trick, arXiv:1809.11096 §3 — absent from the reference even
    # though its G is BigGAN-derived). 0.0 = off (reference parity). When on,
    # the EMA tree updates whenever G updates (the disc_iters cadence), and
    # the per-epoch generator EXPORT + sample grids use the EMA weights; the
    # live weights keep training. Checkpoints are config-coupled: a run with
    # g_ema_decay>0 adds a `g_ema` tree to the state (restore with the same
    # setting).
    g_ema_decay: float = 0.0
    # BigGAN "standing statistics" for the EMA export: number of train-mode
    # G forwards (batch_size each) run under the EMA weights to refresh the
    # BN running stats before each export/grid. The live stats are collected
    # under the LIVE weights; serving the EMA weights with them is measurably
    # broken — rFID 1238 / CER 0.21 vs 73 / 0.002 with standing stats on the
    # same checkpoint (scripts/ema_standing_stats_ab.py, docs/QUALITY.md).
    # 0 disables (export reuses live stats). Ignored when g_ema_decay == 0.
    ema_standing_stat_batches: int = 100
    # Adam update implementation. The update is a pure device-memory
    # bandwidth cost (train/optim.py): 134M params x 28 B/param = 3.75 GB/step.
    #   'optax': stock optax.adam — reference-parity state layout (f32 m, v).
    #   'lean' : train/optim.lean_adam — elides the first-moment buffer when
    #       beta_1 == 0 (EXACT same math, and beta_1=0 IS the reference
    #       default, scrabble_gan.gin:6) and stores the second moment in
    #       `moment_dtype`. 28 -> 16 B/param.
    # Checkpoint-coupled (the optimizer-state leaf set/dtype changes); the
    # workdir's config.json records it and restore/infer auto-load it.
    # Default 'lean' (fewer bytes per step, same math); set 'optax' for the
    # round-2 checkpoint state layout.
    adam_impl: str = "lean"
    # Storage dtype for lean Adam's moments: 'float32' | 'bfloat16'. The EMA
    # math runs in the gradient dtype (f32) either way; bf16 storage costs
    # ~0.2% relative error on the per-parameter step size. Ignored when
    # adam_impl='optax'.
    moment_dtype: str = "float32"


@dataclass(frozen=True)
class SharedSpecs:
    """Reference: shared_specs gin bindings (scrabble_gan.gin:17-26)."""

    epochs: int = 10
    batch_size: int = 16
    latent_dim: int = 128
    embed_y: Tuple[int, int] = (32, 8192)  # filter bank patch dims
    num_gen: int = 16  # images in the fixed visualization grid
    kernel_reg: str = "spectral_norm"  # 'spectral_norm' | 'none'
    g_bw_attention: str = "B3"  # generator blocks with self-attention
    d_bw_attention: str = "B1"  # discriminator blocks with self-attention
    my_rec: bool = False  # BiLSTM recognizer variant (net_architecture.py:82)
    my_disc: bool = False  # DCGAN discriminator variant (net_architecture.py:417)
    # z source for the generator: 'style' = the fork's style-encoder path
    # (net_architecture.py:226-257); 'noise' = upstream ScrabbleGAN sampled z,
    # which is what run_inference.py exercises (SURVEY.md defect #10 — support both).
    z_source: str = "style"
    # Computation dtype for the model forward/backward ('float32' | 'bfloat16').
    # Params are always float32.
    dtype: str = "float32"
    # Compute dtype for the BN-FREE trunks only — D, W, and G's StyleEncoder
    # (all ResNetBlockDown stacks with no batch norm): '' inherits `dtype`;
    # 'bfloat16' halves their activation HBM traffic while G's up-stack
    # (CBN/BN batch statistics — the part pmbf16 showed is noise-sensitive,
    # docs/QUALITY.md) and R (BN + CTC) stay in `dtype`. Params are f32
    # either way, so checkpoints are layout-identical and interchangeable.
    trunk_dtype: str = ""
    # Fused attention kernel (kernels/attention.py) where the program is
    # lowered for CUDA; every other platform runs the plain XLA attention.
    use_pallas_attention: bool = True
    # Up-block ConvTranspose lowering: 'dilated' (stock nn.ConvTranspose) |
    # 'subpixel' (exact parity-phase decomposition, ops/subpixel.py).
    # 'dilated' is the default; subpixel's depth-to-space interleave costs an
    # extra device-memory pass per up-block. Checkpoints are interchangeable.
    conv_lowering: str = "dilated"
    # Rematerialize the generator forward in the backward pass
    # (jax.checkpoint): trades ~1 extra G forward for not storing its
    # activations — enables much larger batches.
    remat: bool = False
    # Ablations (BASELINE.json config 2: G+D adversarial-only training):
    # disable the recognizer CTC path and/or the style-promoter adversary.
    use_recognizer: bool = True
    use_style_promoter: bool = True


@dataclass(frozen=True)
class IOConfig:
    """Reference: io gin bindings (scrabble_gan.gin:29-43)."""

    base_path: str = "./runs/"
    # First-run raw->GAN-Reading converter, by registry name: 'iam' | 'rimes'
    # (data/iam.py DATASET_HANDLERS; the dinterface multi-dataset slot).
    dataset: str = "iam"
    checkpoint_dir: str = "checkpoints/"
    gen_imgs_dir: str = "output/"
    model_dir: str = "model/"
    raw_dir: str = "data/IAM_mygan/img/"
    read_dir: str = "data/IAM_mygan/words-Reading/"
    style_dir: str = "data/style_imgs/"  # reference hardcodes 'Utku_40/' (data_utils.py:109)
    words_file: str = "data/random_words.txt"
    input_dim: Tuple[int, int, int] = (32, 160, 1)  # (H, W_max, C)
    buf_size: int = 80377
    n_classes: int = 52
    # Fixed word length: when set, every real/fake batch is drawn from this
    # single length bucket (the reference's io.seq_len gin key, scrabble_gan.gin
    # `seq_len=None`; configs/1_inference.json pins 5 for fixed-length runs).
    seq_len: Optional[int] = None
    bucket_size: int = 10
    char_vec: str = CHAR_VECTOR
    # Per-batch console logging cadence: None = throttled to ~10 lines/epoch;
    # 1 = the reference's per-step 10-stat print (data_utils.py:444-446).
    log_every: Optional[int] = None
    # Full-train-state checkpoint cadence in epochs (the final epoch is
    # always saved). The per-epoch generator-only export (the reference's
    # save_weights parity, data_utils.py:346-348) is unaffected. Each save
    # fetches ~GBs of state to the host — raise this when resume granularity
    # matters less than wall clock, or set 0 to disable full-state
    # checkpoints entirely (no resume; bench.py's e2e section uses this).
    ckpt_every: int = 1
    # Per-epoch export quality gate (eval/gate.py, VERDICT r4 item 5): number
    # of generated samples scored with the calibrated deterministic rfid_rand
    # metric after every export. The flag (ok/suspect) is written to
    # model/generator/quality_<epoch>.json and the newest 'ok' epoch is kept
    # under the model/generator/latest_good symlink, so a serving consumer
    # never picks up a transiently-broken export (EMA warm-up / D-skirmish
    # epochs). Costs one extra jitted G forward + a tiny fixed conv extractor
    # per epoch. 0 disables (reference parity: unconditional exports).
    export_quality_samples: int = 64
    # Stall self-heal (utils/watchdog.py): if > 0, Trainer.train exits the
    # process with code 86 when no step/fetch completes for this many seconds
    # (a hung device or driver blocks device_get forever). Cold XLA compiles
    # are covered separately by compile_grace_s,
    # so this only needs to exceed the normal step/fetch cadence and the
    # full-state checkpoint fetch. 0 disables (default).
    stall_timeout_s: float = 0.0
    # One-shot watchdog grace window (seconds) consumed at the first dispatch
    # of every NEW batch (shape, dtype) signature and at the first
    # epoch-artifact save: a cold XLA compile legitimately blocks with zero
    # observable progress (minutes for the padded 4-network step), which
    # would otherwise trip stall_timeout_s.
    # Only meaningful when stall_timeout_s > 0. The grace window is NOT blind
    # (utils/watchdog.py probed grace): a scalar device round-trip probe fires
    # every stall_timeout_s/2 during the window, so a backend that dies
    # mid-compile is caught within ~1.5x stall_timeout_s instead of
    # compile_grace_s + stall_timeout_s (~45-60 min at the defaults, the
    # pre-round-5 worst case). The full grace still bounds a healthy-but-slow
    # compile. Bucketed runs re-arm the grace once per new signature, padded
    # runs exactly once.
    compile_grace_s: float = 2700.0


@dataclass(frozen=True)
class ParallelConfig:
    """Data parallelism over a device mesh (new component; no reference
    counterpart — SURVEY.md §5 'Distributed communication backend')."""

    # Number of devices for the data mesh; -1 = all visible devices.
    num_devices: int = -1
    # 'bucketed': one XLA compilation per word-length bucket (exact reference
    # shape semantics, zero padding waste).
    # 'padded': single compilation at max width with width masks.
    shape_mode: str = "bucketed"
    # Fake-label bucket sampling: 'matched' = same bucket as the real batch
    # (10 compiled steps); 'independent' = the REFERENCE's semantics — fake
    # bucket drawn uniformly per step, independent of the real batch's
    # population-weighted bucket (data_utils.py:385-387).
    # Compile cost of 'independent' depends on shape_mode:
    #   'bucketed': lazy per-(real,fake) pair specialization, up to
    #       bucket_size^2 compiles.
    #   'padded': ONE static shape; the true lengths ride as per-sample data
    #       (masks + CTC lengths), so padded+'independent' IS the reference's
    #       independent draw at exactly one compilation (tests/test_pairing.py
    #       pins the distributions; campaign arm 'pi' trained it to 10 epochs).
    bucket_pairing: str = "matched"
    # Batch composition ('padded' shape mode only):
    #   'bucket' (default): every sample in a batch shares one word length —
    #       the reference's regime (its shapes force it, data_utils.py:70-74).
    #   'sample': each sample's length bucket is drawn INDEPENDENTLY by
    #       population weight, so every batch mixes word widths — possible
    #       only because padded mode's masks are per-sample. This is the
    #       mixed-width-batch cell of the bucketed-instability study
    #       (docs/QUALITY.md): D never gets a single-width batch to
    #       specialize against. bucket_pairing still applies per-sample.
    batch_mix: str = "bucket"
    # Train steps fused into one device dispatch (lax.scan). >1 amortizes
    # per-call dispatch/fetch overhead; batches within a chunk share a bucket.
    steps_per_call: int = 1
    # Host input pipeline: batches assembled AND device_put by a background
    # thread into a bounded queue this many entries deep, overlapping both the
    # numpy assembly and the H2D transfer with device compute. 0 = synchronous
    # (round-1 behavior).
    prefetch_depth: int = 2
    # Host->device wire format for image tensors: 'uint8' ships raw bytes and
    # normalizes to [-1,1] on-device inside the jitted step (3.7x less H2D
    # traffic; exact numerics for real images, which are uint8 on disk; style
    # images quantize by <=0.5/127.5 vs the float32 host path). 'float32'
    # restores the exact round-1 wire format.
    transfer_dtype: str = "uint8"
    # FSDP/ZeRO-3-style parameter + optimizer-state sharding over the data
    # mesh (parallel/fsdp.py): every large weight is split across devices and
    # all-gathered by XLA at use; grads reduce-scatter back. Numerics are
    # identical to replicated DP (GSPMD inserts the collectives; tested).
    # Per-device param+optimizer memory drops ~linearly for the big weights
    # (the 13.6M-param filter bank dominates). False = fully replicated.
    fsdp: bool = False
    # Minimum leaf size (elements) worth sharding under fsdp; smaller weights
    # stay replicated (an all-gather of a tiny BN scale costs more than it
    # saves).
    fsdp_min_size: int = 65536
    # Tensor parallelism (parallel/tp.py): >1 reshapes the mesh to a 2-D
    # (data, model) grid and splits every weight's output-channel axis across
    # the model axis — activations inherit channel shardings through GSPMD,
    # so per-device conv FLOPs and activation memory drop with this factor.
    # COMPOSES with fsdp (parallel/fsdp_tp.py): output channels shard on the
    # model axis for compute, the largest remaining axis shards on the data
    # axis for ZeRO-3 memory. num_devices must be divisible.
    model_parallel: int = 1


@dataclass(frozen=True)
class Config:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    shared: SharedSpecs = field(default_factory=SharedSpecs)
    io: IOConfig = field(default_factory=IOConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    seed: int = 0


def _dataclass_from_dict(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        if dataclasses.is_dataclass(f.type) or f.name in (
            "optimizer",
            "shared",
            "io",
            "parallel",
        ):
            sub_cls = {
                "optimizer": OptimizerConfig,
                "shared": SharedSpecs,
                "io": IOConfig,
                "parallel": ParallelConfig,
            }[f.name]
            value = _dataclass_from_dict(sub_cls, value)
        elif isinstance(value, list):
            value = tuple(value)
        kwargs[f.name] = value
    return cls(**kwargs)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None) -> Config:
    """Build a Config from an optional JSON file plus dotted-path overrides.

    `overrides` maps e.g. 'optimizer.g_lr' -> 1e-4 or 'shared.my_rec' -> True.
    """
    data: dict = {}
    if path:
        with open(path) as f:
            data = json.load(f)
        # Checkpoint-layout back-compat (ADVICE r3): configs persisted before
        # the `adam_impl` key existed were written when 'optax' was the only
        # layout — filling the missing key from today's dataclass default
        # ('lean') would silently re-interpret those checkpoints' optimizer
        # tree and fail restore with a leaf mismatch. A file that HAS an
        # optimizer section but no adam_impl key predates the flag: pin it
        # to the layout in force when it was written.
        opt = data.get("optimizer")
        if isinstance(opt, dict) and "adam_impl" not in opt:
            opt["adam_impl"] = "optax"
    cfg = _dataclass_from_dict(Config, data)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg


def apply_overrides(cfg: Config, overrides: dict) -> Config:
    for dotted, value in overrides.items():
        parts = dotted.split(".")
        cfg = _replace_path(cfg, parts, value)
    return cfg


def _replace_path(obj: Any, parts, value):
    if len(parts) == 1:
        current = getattr(obj, parts[0])
        if isinstance(current, bool) and isinstance(value, str):
            value = value.lower() in ("1", "true", "yes")
        elif isinstance(current, int) and not isinstance(current, bool) and isinstance(value, str):
            value = int(value)
        elif isinstance(current, float) and isinstance(value, str):
            value = float(value)
        elif isinstance(current, tuple) and isinstance(value, (list, str)):
            if isinstance(value, str):
                value = tuple(int(v) for v in value.strip("()[] ").split(","))
            else:
                value = tuple(value)
        return dataclasses.replace(obj, **{parts[0]: value})
    sub = getattr(obj, parts[0])
    return dataclasses.replace(obj, **{parts[0]: _replace_path(sub, parts[1:], value)})


def config_to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path: str) -> str:
    """Persist the full config as JSON (the format load_config reads).

    Written by the Trainer into the workdir, the checkpoint dir, and the
    model-export dir so checkpoints are SELF-DESCRIBING: a checkpoint's leaf
    set depends on `parallel.shape_mode` ('padded' adds a filter-bank PAD
    row) and `optimizer.g_ema_decay` (>0 adds a g_ema tree) — without the
    config, restoring a padded/EMA run requires the user to re-specify those
    flags or the restore fails with a tree mismatch."""
    with open(path, "w") as f:
        json.dump(config_to_dict(cfg), f, indent=2)
        f.write("\n")
    return path


def discover_config(start: str, max_up: int = 4) -> Optional[str]:
    """Find the config.json describing a checkpoint/export/workdir path.

    Walks from `start` (a file or directory) upward at most `max_up` levels —
    enough to reach the workdir root from any artifact inside it (e.g.
    <workdir>/model/generator/<epoch>). Returns the path or None."""
    d = os.path.abspath(start)
    if os.path.isfile(d):
        d = os.path.dirname(d)
    for _ in range(max_up + 1):
        candidate = os.path.join(d, "config.json")
        if os.path.isfile(candidate):
            return candidate
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return None

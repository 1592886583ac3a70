"""The training driver: epoch/batch loop, host input feeding, metrics, per-epoch
visualization, checkpoint/resume, and the final animation.

Capability parity with train() (data_utils.py:198-352) + main() (main.py:54-117),
redesigned around one compiled step:
- the step is ONE compiled function (scrabblegan.train.step); the jit cache
  specializes it per (real-bucket, fake-bucket) shape pair — 10 specializations in
  'matched' pairing (SURVEY.md §7 "per-bucket jit cache"),
- host batch assembly is numpy with static shapes and the device transfer is a
  sharded device_put over the data mesh,
- checkpoints are full-state saves (train/checkpoint.py) WITH restore-on-start (fixing the
  reference's vestigial checkpoint, SURVEY.md defect #6), plus the reference's
  per-epoch generator-only export,
- per-step timing uses block_until_ready for honest steps/sec (SURVEY.md §5
  tracing note).
"""

from __future__ import annotations

import os
import sys
import queue
import threading
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from scrabblegan.config import Config
from scrabblegan.data.loaders import (
    BucketedDataset,
    load_random_word_list,
    load_style_images,
    sample_fake_labels,
)
from scrabblegan.parallel.mesh import (
    batch_sharding,
    make_mesh,
    make_parallel_train_step,
    replicate_sharding,
)
from scrabblegan.train import checkpoint as ckpt_lib
from scrabblegan.train.metrics import SummaryWriter
from scrabblegan.train.step import METRIC_NAMES
from scrabblegan.train.state import TrainState, build_models, create_train_state, param_count
from scrabblegan.utils.viz import make_animation, save_epoch_grid


def bucketed_regime_warning(cfg: Config, epochs: int):
    """Loud-flag string for multi-epoch bucketed runs, else None.

    Every bucketed arm of the 12-arm quality campaign collapsed past ~1 epoch
    (D saturates, rFID 759->3041, CER 1.0) while the padded regime trains
    stably on the same data — docs/QUALITY.md rounds 3-4. Bucketed stays
    available for reference-exact shape semantics, but a long run in it
    deserves a loud flag (VERDICT r4 item 4)."""
    if cfg.parallel.shape_mode != "bucketed" or epochs <= 1:
        return None
    return ("=" * 72 + "\nWARNING: parallel.shape_mode='bucketed' is the "
            "measured-UNSTABLE training\nregime beyond ~1 epoch (every "
            "bucketed quality-campaign arm collapsed;\nsee docs/QUALITY.md). "
            "Use configs/recommended.json or --set\n"
            "parallel.shape_mode=padded for the stable regime.\n" + "=" * 72)


class _Prefetcher:
    """Background-thread input pipeline: assembles batches and enqueues the
    device transfers ahead of dispatch (double buffering). All batch
    randomness lives in the producer thread, drawing from the same np_rng
    sequence the synchronous path uses — identical batch streams."""

    def __init__(self, make_batch, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            while not self._stop.is_set():
                item = self._make()
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.25)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced on the consumer side
            self._err = e

    def get(self):
        while True:
            if self._err is not None:
                raise self._err
            try:
                return self._q.get(timeout=0.25)
            except queue.Empty:
                if not self._thread.is_alive() and self._err is None:
                    raise RuntimeError("prefetcher thread exited unexpectedly")

    def close(self):
        self._stop.set()
        # drain so a blocked put can observe the stop flag
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)


class Trainer:
    def __init__(self, cfg: Config, workdir: Optional[str] = None, verbose: bool = True):
        self.cfg = cfg
        self.verbose = verbose
        base = workdir or cfg.io.base_path
        self.workdir = base
        self.gen_path = os.path.join(base, cfg.io.gen_imgs_dir)
        self.ckpt_path = os.path.join(base, cfg.io.checkpoint_dir)
        self.model_path = os.path.join(base, cfg.io.model_dir)
        for p in (self.gen_path, self.ckpt_path, self.model_path):
            os.makedirs(p, exist_ok=True)
        # self-describing artifacts: the exact config lands next to the
        # workdir, the full-state checkpoints, and the G-only exports, so
        # infer/evaluate/export auto-restore padded/EMA runs with no manual
        # --set (config.save_config docstring; reference main.py:93-102 never
        # persisted its gin bindings either — component 22 upgraded)
        from scrabblegan.config import save_config

        for p in (base, self.ckpt_path, self.model_path):
            save_config(cfg, os.path.join(p, "config.json"))

        self.models = build_models(cfg)
        self.mesh = make_mesh(cfg.parallel.num_devices,
                              cfg.parallel.model_parallel)
        self.steps_per_call = max(1, cfg.parallel.steps_per_call)
        state_shapes = None
        if cfg.parallel.fsdp or cfg.parallel.model_parallel > 1:
            state_shapes = jax.eval_shape(
                lambda: create_train_state(cfg, jax.random.PRNGKey(cfg.seed),
                                           self.models))
        self.step_fn = make_parallel_train_step(
            cfg, self.models, self.mesh, chunked=self.steps_per_call > 1,
            state_shapes=state_shapes)
        self._rep = replicate_sharding(self.mesh)
        # fsdp/tp: the state enters/leaves the step in sharded layout
        from scrabblegan.parallel.mesh import state_sharding_for

        self._state_sh = state_sharding_for(self.cfg, self.mesh, state_shapes)
        if self.steps_per_call > 1:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._bsh = NamedSharding(self.mesh, P(None, "data"))
        else:
            self._bsh = batch_sharding(self.mesh)
        self.np_rng = np.random.default_rng(cfg.seed)
        # 'uint8' wire format: batches ship raw bytes; the jitted step
        # normalizes on-device (step.normalize_batch_images)
        self._u8 = cfg.parallel.transfer_dtype == "uint8"
        if cfg.parallel.batch_mix not in ("bucket", "sample"):
            raise ValueError(f"unknown batch_mix {cfg.parallel.batch_mix!r}")
        if (cfg.parallel.batch_mix == "sample"
                and cfg.parallel.shape_mode != "padded"):
            raise ValueError("batch_mix='sample' requires shape_mode='padded' "
                             "(bucketed batches are single-width by construction)")
        self._mixed = cfg.parallel.batch_mix == "sample"
        # (epoch_idx, batch_idx) of the first non-finite metric, if training
        # diverged (the loop stops instead of training on NaN)
        self.diverged_at = None

    # ------------------------------------------------------------------ setup
    def init_state(self, resume: bool = True) -> TrainState:
        rng = jax.random.PRNGKey(self.cfg.seed)
        state = create_train_state(self.cfg, rng, self.models)
        state = jax.device_put(state, self._state_sh)
        if resume:
            restored, step = ckpt_lib.restore_state(self.ckpt_path, state)
            if restored is not None:
                if self.verbose:
                    print(f"resumed from checkpoint at step {step}")
                return jax.device_put(restored, self._state_sh)
        if self.verbose:
            from scrabblegan.utils.summary import summarize_state

            print("initialized networks (model.summary() analog):")
            summarize_state(state)
        return state

    def load_data(self, read_dir: Optional[str] = None,
                  style_dir: Optional[str] = None,
                  words_file: Optional[str] = None):
        cfg = self.cfg
        read_dir = read_dir or cfg.io.read_dir
        style_dir = style_dir or cfg.io.style_dir
        words_file = words_file or cfg.io.words_file
        self.dataset = BucketedDataset(read_dir, cfg.io.input_dim,
                                       cfg.io.bucket_size, cfg.io.char_vec,
                                       seed=cfg.seed)
        self.style_train, self.style_validate = load_style_images(
            style_dir, cfg.io.input_dim, seed=cfg.seed)
        if not self.style_validate:
            self.style_validate = self.style_train[:1]
        self.random_words = load_random_word_list(words_file, cfg.io.bucket_size,
                                                  cfg.io.char_vec)
        if self._u8:  # quantized style bank for the uint8 wire format
            self._style_u8 = np.clip(
                np.rint(np.stack(self.style_train) * 127.5 + 127.5),
                0, 255).astype(np.uint8)
        # fixed visualization seed (main.py:104-108)
        k = cfg.shared.num_gen
        idx = self.np_rng.integers(0, len(self.style_validate), size=k)
        self.seed_style = np.stack([self.style_validate[i] for i in idx])[..., None]
        # reference draws the viz word length from [4, bucket_size-1]
        # (main.py:107); clamp the lower bound for small bucket configs
        lo = min(4, cfg.io.bucket_size - 1)
        seed_bucket = (int(cfg.io.seq_len) - 1 if cfg.io.seq_len
                       else int(self.np_rng.integers(lo, cfg.io.bucket_size)))
        self.seed_labels = sample_fake_labels(self.np_rng, self.random_words, k,
                                              seed_bucket + 1)
        # fixed z for z_source='noise' epoch grids — the noise-mode analog of
        # the reference's fixed seed (main.py:104-108); without it the
        # per-epoch artifact dump would have no latent to feed the generator
        self.seed_z = self.np_rng.standard_normal(
            (k, cfg.shared.latent_dim)).astype(np.float32)

    # ------------------------------------------------------------------ batch
    def _assemble(self, bucket=None, fake_bucket=None) -> dict:
        """One host-side batch (numpy). Bucket choices may be pinned so chunked
        dispatches share a static shape."""
        if self._mixed:
            return self._assemble_mixed()
        cfg = self.cfg
        bsz = cfg.shared.batch_size
        if bucket is None and cfg.io.seq_len:
            bucket = int(cfg.io.seq_len)  # fixed-length runs (io.seq_len gin key)
        real_imgs, real_labels, bucket = self.dataset.sample_batch(
            bsz, bucket=bucket, raw=self._u8)
        if fake_bucket is None:
            if cfg.io.seq_len:
                fake_bucket = int(cfg.io.seq_len)
            elif cfg.parallel.bucket_pairing == "matched":
                fake_bucket = bucket
            else:  # 'independent': reference semantics (data_utils.py:386)
                fake_bucket = int(self.np_rng.integers(1, cfg.io.bucket_size + 1))
        fake_labels = sample_fake_labels(self.np_rng, self.random_words, bsz,
                                         fake_bucket)
        style_idx = self.np_rng.integers(0, len(self.style_train), size=bsz)
        if self._u8:
            style_imgs = self._style_u8[style_idx][..., None]
        else:
            style_imgs = np.stack(
                [self.style_train[i] for i in style_idx])[..., None].astype(np.float32)
        batch = {
            "real_imgs": real_imgs,
            "real_labels": real_labels,
            "style_imgs": style_imgs,
            "fake_labels": fake_labels,
        }
        if cfg.parallel.shape_mode == "padded":
            batch = self._pad_batch(batch, bucket, fake_bucket)
        return batch

    def _assemble_mixed(self) -> dict:
        """batch_mix='sample' (padded mode): every sample's real length bucket
        is drawn independently by population weight, so one batch mixes word
        widths — the step's per-sample masks/CTC lengths handle the rest.
        bucket_pairing applies per-sample ('matched': fake length = that
        sample's real length; 'independent': uniform draw per sample)."""
        cfg = self.cfg
        bsz = cfg.shared.batch_size
        h, _, c = cfg.io.input_dim
        l_max = cfg.io.bucket_size
        w_max = (h // 2) * l_max
        pad_id = cfg.io.n_classes
        ds = self.dataset
        if cfg.io.seq_len:
            real_buckets = np.full((bsz,), int(cfg.io.seq_len))
        else:
            real_buckets = np.array([ds.sample_bucket() for _ in range(bsz)])
        if self._u8:
            real_imgs = np.full((bsz, h, w_max, c), 255, np.uint8)
        else:
            real_imgs = np.full((bsz, h, w_max, c), 1.0, np.float32)
        real_labels = np.full((bsz, l_max), pad_id, np.int32)
        for b in np.unique(real_buckets):
            rows = np.flatnonzero(real_buckets == b)
            imgs, labs, _ = ds.sample_batch(len(rows), bucket=int(b),
                                            raw=self._u8)
            real_imgs[rows, :, :imgs.shape[2]] = imgs
            real_labels[rows, :b] = labs
        if cfg.io.seq_len or cfg.parallel.bucket_pairing == "matched":
            fake_buckets = real_buckets.copy()
        else:  # 'independent', per-sample (data_utils.py:386 semantics)
            fake_buckets = self.np_rng.integers(1, l_max + 1, size=bsz)
        fake_labels = np.full((bsz, l_max), pad_id, np.int32)
        for b in np.unique(fake_buckets):
            rows = np.flatnonzero(fake_buckets == b)
            labs = sample_fake_labels(self.np_rng, self.random_words,
                                      len(rows), int(b))
            fake_labels[rows, :b] = labs
        style_idx = self.np_rng.integers(0, len(self.style_train), size=bsz)
        if self._u8:
            style_imgs = self._style_u8[style_idx][..., None]
        else:
            style_imgs = np.stack(
                [self.style_train[i] for i in style_idx])[..., None].astype(np.float32)
        return {
            "real_imgs": real_imgs,
            "real_labels": real_labels,
            "style_imgs": style_imgs,
            "fake_labels": fake_labels,
            "real_lengths": real_buckets.astype(np.int32),
            "fake_lengths": fake_buckets.astype(np.int32),
        }

    def next_batch(self):
        """steps_per_call==1: one device batch; >1: a stacked chunk of K batches
        sharing one bucket (leading axis K)."""
        k = self.steps_per_call
        if k == 1:
            return jax.device_put(self._assemble(), self._bsh)
        if self._mixed:
            # mixed batches all share the padded static shape — no pinning
            batches = [self._assemble() for _ in range(k)]
            stacked = {key: np.stack([b[key] for b in batches])
                       for key in batches[0]}
            return jax.device_put(stacked, self._bsh)
        if self.cfg.io.seq_len:
            bucket = fake_bucket = int(self.cfg.io.seq_len)
        else:
            bucket = self.dataset.sample_bucket()
            fake_bucket = (bucket if self.cfg.parallel.bucket_pairing == "matched"
                           else int(self.np_rng.integers(1, self.cfg.io.bucket_size + 1)))
        batches = [self._assemble(bucket=bucket, fake_bucket=fake_bucket)
                   for _ in range(k)]
        stacked = {key: np.stack([b[key] for b in batches]) for key in batches[0]}
        return jax.device_put(stacked, self._bsh)

    def _pad_batch(self, batch, real_len: int, fake_len: int):
        """'padded' mode: white-pad images to max width, pad labels with the pad
        id (n_classes), and attach true lengths — one static shape per epoch."""
        cfg = self.cfg
        l_max = cfg.io.bucket_size
        w_max = (cfg.io.input_dim[0] // 2) * l_max
        bsz = batch["real_labels"].shape[0]
        pad_id = cfg.io.n_classes

        def pad_imgs(imgs):
            pad_w = w_max - imgs.shape[2]
            if pad_w <= 0:
                return imgs
            fill = 255 if imgs.dtype == np.uint8 else 1.0  # white either way
            return np.pad(imgs, ((0, 0), (0, 0), (0, pad_w), (0, 0)),
                          constant_values=fill)

        def pad_labels(labels):
            pad_l = l_max - labels.shape[1]
            if pad_l <= 0:
                return labels
            return np.pad(labels, ((0, 0), (0, pad_l)), constant_values=pad_id)

        batch["real_imgs"] = pad_imgs(batch["real_imgs"])
        batch["real_labels"] = pad_labels(batch["real_labels"])
        batch["fake_labels"] = pad_labels(batch["fake_labels"])
        batch["real_lengths"] = np.full((bsz,), real_len, np.int32)
        batch["fake_lengths"] = np.full((bsz,), fake_len, np.int32)
        return batch

    # ------------------------------------------------------------------ train
    def train(self, epochs: Optional[int] = None,
              batches_per_epoch: Optional[int] = None,
              resume: bool = True, profile_steps: int = 0) -> TrainState:
        cfg = self.cfg
        epochs = epochs if epochs is not None else cfg.shared.epochs
        if batches_per_epoch is None:
            batches_per_epoch = int(cfg.io.buf_size / cfg.shared.batch_size) + 1

        warning = bucketed_regime_warning(cfg, epochs)
        if warning:
            # stderr: stdout may carry machine-readable output (bench.py's
            # JSON stream drives the e2e section through this loop)
            print(warning, file=sys.stderr, flush=True)

        # Stall self-heal: a hung device call blocks the next device_get
        # forever (utils/watchdog.py). Exit 86 lets a supervisor retry;
        # resume picks up from the last checkpoint. Started BEFORE
        # init_state: on a cold cache the init graphs compile for minutes
        # with no file activity, and an outer file-activity supervisor
        # (scripts/run_campaign.sh) would read that as a stall unless the
        # watchdog's heartbeat file is already being touched.
        watchdog = None
        if cfg.io.stall_timeout_s:
            from scrabblegan.utils.watchdog import (
                StallWatchdog,
                device_roundtrip_probe,
            )

            # the liveness probe discriminates compile-in-progress from a
            # dead backend during grace windows (VERDICT r4 item 9): a stall
            # landing on a cold compile is now caught in <= 2x stall_timeout
            # instead of compile_grace + stall_timeout (~45-60 min)
            watchdog = StallWatchdog(
                cfg.io.stall_timeout_s,
                touch_file=os.path.join(self.workdir, ".heartbeat"),
                probe=device_roundtrip_probe()).start()
            # covers the init compiles AND a multi-GB checkpoint restore fetch
            watchdog.grace(cfg.io.compile_grace_s)

        state = self.init_state(resume=resume)
        if watchdog:
            watchdog.beat()
        start_step = int(jax.device_get(state.step))
        start_epoch = start_step // batches_per_epoch
        writer = SummaryWriter(self.gen_path, append=start_step > 0)
        rng = jax.random.PRNGKey(cfg.seed + 1)

        if self.verbose:
            print(f"no. training samples:  {self.dataset.num_samples}")
            print(f"batch size:            {cfg.shared.batch_size}")
            print(f"no. batch_per_epoch:   {batches_per_epoch}")
            print(f"epoch size:            {epochs}")
            print(f"devices:               {len(self.mesh.devices.flat)}")
            print("training...")

        # io.log_every=1 restores the reference's per-step 10-stat print
        # (data_utils.py:444-446); default throttles to ~10 lines per epoch
        log_every = (int(cfg.io.log_every) if cfg.io.log_every
                     else max(1, batches_per_epoch // 10))
        k = self.steps_per_call
        calls_per_epoch = max(1, batches_per_epoch // k)
        if self.verbose and k > 1 and batches_per_epoch % k:
            print(f"steps_per_call={k}: epoch rounded to {calls_per_epoch * k} batches")

        # Metric fetch batching: device_get of a dict of 16 tiny scalars costs
        # one device->host transfer PER ARRAY. Stack K steps' metrics into ONE
        # device array and fetch that: one transfer per flush_every
        # dispatches. log_every=1 keeps per-step flushes (the
        # reference's per-step print parity costs what it costs).
        flush_every = max(1, min(32, log_every))
        stack_metrics = jax.jit(lambda ms: jnp.stack(
            [jnp.stack([m[name] for name in METRIC_NAMES]) for m in ms]))

        # Divergence guard: a NaN/Inf step poisons every later step, so detect
        # it at metric-flush time and stop the run with the last good epoch's
        # artifacts intact (the reference would silently train on NaN).
        diverged = [None]

        # cold-compile grace: the first dispatch of each batch shape blocks in
        # XLA compile for minutes with no beats — announce it so the watchdog
        # (and its heartbeat file) don't read a healthy compile as a stall
        seen_shapes: set = set()
        first_artifacts = True

        def grace_for_new_shape(batch):
            # dtype is part of the jit specialization key too (e.g. a float32
            # batch after uint8 wire batches recompiles just as cold)
            sig = tuple((name, tuple(v.shape), str(v.dtype))
                        for name, v in sorted(batch.items()))
            if sig not in seen_shapes:
                seen_shapes.add(sig)
                if watchdog:
                    watchdog.grace(cfg.io.compile_grace_s)

        def flush_pending(pending):
            """Fetch the stacked metrics of a block of completed dispatches and
            log/record each step's row."""
            if not pending:
                return
            stacked = np.asarray(jax.device_get(
                stack_metrics([m for (_, _, m) in pending])))
            if watchdog:
                watchdog.beat()
            for (e_idx, call_idx, _), vec in zip(pending, stacked):
                # vec: (16,) for k == 1, (16, k) for chunked dispatches
                rows = ([dict(zip(METRIC_NAMES, vec))] if k == 1 else
                        [{name: vec[j, i] for j, name in enumerate(METRIC_NAMES)}
                         for i in range(k)])
                for i, row in enumerate(rows):
                    b_idx = call_idx * k + i
                    writer.write_batch(e_idx, b_idx, row)
                    if diverged[0] is None and not (
                            np.isfinite(row["g_loss_final"])
                            and np.isfinite(row["d_loss"])):
                        diverged[0] = (e_idx, b_idx)
                    if self.verbose and (b_idx + 1) % log_every == 0:
                        print(
                            f">{e_idx + 1}, {b_idx + 1}/{calls_per_epoch * k}, "
                            f"d={row['d_loss']:.3f}, d_real={row['d_loss_real']:.3f}, "
                            f"d_fake={row['d_loss_fake']:.3f}, g_trad={row['g_loss']:.3f}, "
                            f"r_loss_fake={row['r_loss_fake']:.3f}, "
                            f"g_loss={row['g_loss_final']:.3f}, "
                            f"r={row['r_loss_real']:.3f}, s={row['s_loss_real']:.3f}")

        if profile_steps:
            # --profile N: capture a jax.profiler trace of N real train
            # dispatches (they advance state) and print honest steps/sec
            from scrabblegan.utils import profiling

            trace_dir = os.path.join(self.gen_path, "trace")
            timer = profiling.StepTimer(warmup=min(2, max(0, profile_steps - 1)))
            metrics = None
            with profiling.trace(trace_dir):
                for _ in range(profile_steps):
                    batch = self.next_batch()
                    rng, step_rng = jax.random.split(rng)
                    if k > 1:
                        step_rng = jax.random.split(step_rng, k)
                    # first-of-shape profile dispatches compile cold too —
                    # same watchdog grace as the main loop
                    grace_for_new_shape(batch)
                    with profiling.annotate("train_step"):
                        state, metrics = self.step_fn(state, batch, step_rng)
                    timer.tick(metrics)
            if self.verbose:
                print(f"[profile] {profile_steps} dispatches traced to "
                      f"{trace_dir}; {timer.steps_per_sec * k:.2f} steps/s")

        # background producer: assembly + H2D transfer run ahead of dispatch
        prefetcher = (None if cfg.parallel.prefetch_depth <= 0 else
                      _Prefetcher(self.next_batch,
                                  depth=cfg.parallel.prefetch_depth))
        try:
            for epoch_idx in range(start_epoch, epochs):
                t0 = time.time()
                pending = []
                next_batch = (prefetcher.get() if prefetcher
                              else self.next_batch())
                for call_idx in range(calls_per_epoch):
                    batch = next_batch
                    rng, step_rng = jax.random.split(rng)
                    if k > 1:
                        step_rng = jax.random.split(step_rng, k)
                    grace_for_new_shape(batch)
                    state, metrics = self.step_fn(state, batch, step_rng)
                    # host-side work for the next dispatch overlaps the device
                    if call_idx + 1 < calls_per_epoch:
                        next_batch = (prefetcher.get() if prefetcher
                                      else self.next_batch())
                    pending.append((epoch_idx, call_idx, metrics))
                    if len(pending) > flush_every:
                        # keep the newest dispatch out of the fetch so the
                        # device stays one step ahead of the host
                        flush_pending(pending[:-1])
                        pending = pending[-1:]
                    if diverged[0] is not None:
                        break
                flush_pending(pending)
                writer.end_epoch()

                jax.block_until_ready(state)
                if watchdog:
                    watchdog.beat()
                self.last_epoch_secs = time.time() - t0
                # batch-loop wall per epoch (artifacts excluded), appended in
                # epoch order — bench.py takes the best warm epoch
                if not hasattr(self, "epoch_secs"):
                    self.epoch_secs = []
                self.epoch_secs.append(self.last_epoch_secs)
                if self.verbose:
                    print(f"Time for epoch {epoch_idx + 1} is "
                          f"{self.last_epoch_secs:.1f} sec")

                if diverged[0] is not None:
                    self.diverged_at = diverged[0]
                    print(f"DIVERGED: non-finite metrics at epoch "
                          f"{diverged[0][0] + 1} batch {diverged[0][1] + 1}; "
                          f"stopping (state not saved — last good export: "
                          f"epoch {epoch_idx})")
                    break
                if first_artifacts:
                    # first save compiles the inference-mode G (and the
                    # standing-stats refresh when EMA is on)
                    first_artifacts = False
                    if watchdog:
                        watchdog.grace(cfg.io.compile_grace_s)
                self.save_epoch_artifacts(state, epoch_idx + 1,
                                          final=epoch_idx + 1 == epochs)
                if watchdog:
                    watchdog.beat()
        finally:
            if watchdog:
                watchdog.stop()
            if prefetcher is not None:
                prefetcher.close()

        writer.close()
        make_animation(self.gen_path, "biggan.png")
        return state

    # ----------------------------------------------------------------- extras
    def save_epoch_artifacts(self, state: TrainState, epoch: int,
                             final: bool = True) -> None:
        # EMA serving needs its own BN statistics (standing_stats docstring);
        # grid and export share one refresh so they show the same generator
        serve_stats = self.standing_stats(state)
        imgs = self.generate(state, self.seed_labels, self.seed_style,
                             z=getattr(self, "seed_z", None), stats=serve_stats)
        save_epoch_grid(np.asarray(imgs), self.gen_path, epoch)
        # Full-state fetch is ~GBs; honor io.ckpt_every (final epoch always saved; 0 disables full-state
        # checkpoints entirely), and reuse the host copy for the G-only
        # export instead of fetching G twice.
        host_state = None
        ckpt_every = int(self.cfg.io.ckpt_every)
        if ckpt_every > 0 and (final or epoch % ckpt_every == 0):
            host_state = jax.device_get(state)
            ckpt_lib.save_state(self.ckpt_path, host_state,
                                int(host_state.step))
        # The export serves the EMA weights when optimizer.g_ema_decay > 0
        # (BigGAN convention); the live weights stay in the full-state ckpt.
        use_ema = state.g_ema is not None
        if host_state is not None:
            g_params = host_state.g_ema if use_ema else host_state.g_params
        else:
            g_params = jax.device_get(
                state.g_ema if use_ema else state.g_params)
        g_stats = (jax.device_get(serve_stats) if serve_stats is not None
                   else (host_state.g_stats if host_state is not None
                         else jax.device_get(state.g_stats)))
        ckpt_lib.save_generator(self.model_path, g_params, g_stats, epoch)
        # reference parity: R weights save alongside G every epoch
        # (data_utils.py:346-348) — the rFID/CER extractor can then be rebuilt
        # from any epoch without the full-state checkpoint
        if self.cfg.shared.use_recognizer:
            if host_state is not None:
                r_params, r_stats = host_state.r_params, host_state.r_stats
            else:
                r_params, r_stats = jax.device_get(
                    (state.r_params, state.r_stats))
            ckpt_lib.save_recognizer(self.model_path, r_params, r_stats, epoch)
        # quality gate (VERDICT r4 item 5): flag the export with the
        # calibrated rfid_rand and keep latest_good pointing at the newest
        # non-suspect epoch. A metric failure must never kill training.
        if (self.cfg.io.export_quality_samples > 0
                and getattr(self, "dataset", None) is not None):
            try:
                result = self._gate_export(state, serve_stats, epoch)
                if self.verbose and result is not None:
                    print(f"export gate epoch {epoch}: {result['flag']} "
                          f"(rfid_rand {result['rfid_rand']:.2f}, floor "
                          f"{result['real_floor']:.2f}, excess "
                          f"{result['excess']:.2f})")
            except Exception as e:  # noqa: BLE001
                print(f"export gate failed (export kept, unflagged): {e!r}")

    def _gate_export(self, state: TrainState, serve_stats, epoch: int):
        """Score this epoch's export with the calibrated deterministic
        rfid_rand gate (eval/gate.py) and annotate the export dir.

        Everything is drawn from a PRIVATE fixed-seed rng — the training batch
        stream (dataset._rng / np_rng) must not advance, or adding the gate
        would change training numerics. Images are gathered straight from the
        dataset's uint8 store rather than via sample_batch for the same
        reason. Returns the result dict, or None when the chosen bucket has
        no real samples."""
        from scrabblegan.eval.gate import annotate_export, score_export

        cfg = self.cfg
        n = int(cfg.io.export_quality_samples)
        gate_rng = np.random.default_rng(cfg.seed + 0xE0)
        # the grid's word length keeps gen/real shapes equal; fall back to the
        # most-populated bucket if that length has no real data
        bucket = int(self.seed_labels.shape[1])
        if len(self.dataset.labels.get(bucket, ())) == 0:
            bucket = max(self.dataset.nonempty,
                         key=lambda b: len(self.dataset.labels[b]))
        # generate in chunks of the GRID batch size: when the gate bucket is
        # the grid's word length (the common case), every chunk reuses the
        # epoch grid's compiled shape — no second inference compile
        k = max(1, int(cfg.shared.num_gen))
        chunks = []
        for _ in range((n + k - 1) // k):
            labels = sample_fake_labels(gate_rng, self.random_words, k, bucket)
            if cfg.shared.z_source == "style":
                idx = gate_rng.integers(0, len(self.style_validate), size=k)
                cond = np.stack([self.style_validate[i]
                                 for i in idx])[..., None].astype(np.float32)
                out = self.generate(state, labels, style_imgs=cond,
                                    stats=serve_stats)
            else:
                z = gate_rng.standard_normal(
                    (k, cfg.shared.latent_dim)).astype(np.float32)
                out = self.generate(state, labels, z=z, stats=serve_stats)
            chunks.append(np.asarray(jax.device_get(out)).astype(np.float32))
        gen = np.concatenate(chunks, 0)[:n]
        store = self.dataset.images[bucket]
        ridx = gate_rng.integers(0, len(store), size=2 * n)
        real = store[ridx].astype(np.float32)
        real = (real - 127.5) / 127.5
        if getattr(self, "_gate_extractor", None) is None:
            from scrabblegan.eval.fid import random_features

            self._gate_extractor = random_features()
        result = score_export(gen, real, extractor=self._gate_extractor)
        annotate_export(self.model_path, epoch, result)
        return result

    def standing_stats(self, state: TrainState, n_batches: int | None = None):
        """BigGAN standing statistics (arXiv:1809.11096 sec. 3): refresh G's BN
        running stats with train-mode forwards under the EMA weights.

        The live g_stats are collected under the LIVE weights; pairing them
        with the EMA weights is measurably broken — on the same pmema
        checkpoint: rFID 1238 / CER 0.21 served with live stats vs
        **73 / 0.002** with standing stats, while the live generator scores
        207 / 0.028 (scripts/ema_standing_stats_ab.py, docs/QUALITY.md).

        Returns a refreshed batch_stats tree (device), or None when EMA is
        off / optimizer.ema_standing_stat_batches == 0 (callers then serve
        the live stats). Conditioning batches come from the training batch
        maker, so the stats see the training input distribution."""
        n = (self.cfg.optimizer.ema_standing_stat_batches
             if n_batches is None else n_batches)
        if state.g_ema is None or n <= 0 or getattr(self, "dataset", None) is None:
            return None
        cfg = self.cfg
        if getattr(self, "_standing_fn", None) is None:
            G = self.models.generator
            z_source = cfg.shared.z_source

            def one(params, stats, labels, cond, lengths):
                kw = {"style_imgs": cond} if z_source == "style" else {"z": cond}
                if lengths is not None:
                    kw["lengths"] = lengths
                _, muts = G.apply({"params": params, "batch_stats": stats},
                                  labels, train=True,
                                  mutable=["batch_stats"], **kw)
                return muts["batch_stats"]

            self._standing_fn = jax.jit(one)
        padded = cfg.parallel.shape_mode == "padded"
        # one static shape: pin the fake bucket (bucketed mode recompiles per
        # length otherwise; channel-wise BN stats don't care which length)
        pin = int(self.seed_labels.shape[1]) if not padded else None
        stats = state.g_stats
        for _ in range(n):
            batch = self._assemble(bucket=pin, fake_bucket=pin)
            labels = batch["fake_labels"]
            if cfg.shared.z_source == "style":
                cond = batch["style_imgs"]
                if cond.dtype == np.uint8:  # uint8 wire format
                    cond = (cond.astype(np.float32) - 127.5) / 127.5
            else:
                cond = self.np_rng.standard_normal(
                    (labels.shape[0], cfg.shared.latent_dim)).astype(np.float32)
            lengths = batch.get("fake_lengths") if padded else None
            stats = self._standing_fn(state.g_ema, stats, labels, cond, lengths)
        return stats

    def generate(self, state: TrainState, labels: np.ndarray,
                 style_imgs: Optional[np.ndarray] = None,
                 z: Optional[np.ndarray] = None, stats=None):
        """Inference-mode generation on the current params (BN uses running stats,
        matching generate_and_save_images' training=False, data_utils.py:507).
        Uses the EMA weights when enabled — the grids then show exactly what
        the per-epoch export serves. `stats` overrides the BN statistics
        (standing_stats); default = the live running stats.

        Jitted and cached: an un-jitted Module.apply dispatches op-by-op. The
        fixed-seed grid reuses one compilation; new label shapes just add
        jit-cache entries."""
        params = state.g_ema if state.g_ema is not None else state.g_params
        variables = {"params": params,
                     "batch_stats": stats if stats is not None else state.g_stats}
        if getattr(self, "_gen_fn", None) is None:
            G = self.models.generator
            z_source = self.cfg.shared.z_source

            def _gen(variables, labels, cond):
                kw = {"style_imgs": cond} if z_source == "style" else {"z": cond}
                return G.apply(variables, labels, train=False, **kw)

            self._gen_fn = jax.jit(_gen)
        cond = style_imgs if self.cfg.shared.z_source == "style" else z
        return self._gen_fn(variables, labels, cond)

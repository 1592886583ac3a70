#!/usr/bin/env python
"""Benchmark: generator inference throughput and train step rate on one GPU.

Prints the result as a JSON line on stdout, re-emitted after every completed
section (each a superset of the previous), so the LAST JSON line holds
everything measured. All other output goes to stderr, and every number there
carries the card's name and power limit. A failing section makes the process
exit non-zero after printing what it measured.

Sections (the order they run):
  1. inference len-5  (images/s + MFU)
  2. train step len-5 (raw device rate, batch 16 = the reference schedule)
  3. e2e trainer      (real Trainer loop incl. host pipeline, best warm epoch;
                       reuses section 2's compiled step via the process memo
                       in parallel/mesh.py)
  4. inference len-10
  5. train step len-10

Config mirrors BASELINE.json config 1 for inference: the generator, fixed-length
words, sampled-z path, inference mode, bfloat16 compute (params fp32).

Measurement: the K timed forward passes run inside ONE jitted lax.scan whose
carry depends on each iteration's output, so none can be elided or overlapped
away; a device -> host fetch of the result ends each timed region.

MFU divides the analytic matmul/conv FLOPs (utils/flops.py) by the dense bf16
peak of the card, looked up by `device_kind` in PEAK_BF16_FLOPS (NVIDIA data
sheets). A card not in the table gets no MFU.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

# Dense bf16 tensor-core peak by jax device_kind (NVIDIA H100 data sheet).
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,  # H100 SXM
    "NVIDIA H100 PCIe": 756e12,
}

# analytic-FLOPs cache (utils/flops.matmul_flops_cached): entries are keyed on
# config + arg shapes + jax version, so config/architecture changes re-trace
_FLOPS_CACHE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "docs", "perf", "flops_cache.json")

_RESULT = {
    "metric": "word_images_per_sec_per_chip",
    "value": None,
    "unit": "images/s",
    "extra": {},
}
_CARD = {"line": ""}


def log(*a):
    print(*a, f"[{_CARD['line']}]", file=sys.stderr, flush=True)


def emit():
    """(Re-)print the result line with everything measured so far."""
    print(json.dumps(_RESULT), flush=True)


def _mfu(flops_per_sec: float):
    import jax

    peak = PEAK_BF16_FLOPS.get(jax.devices()[0].device_kind)
    return None if peak is None else round(flops_per_sec / peak, 4)


def bench_inference(length: int, iters: int, batch: int = 1024):
    import jax
    import jax.numpy as jnp

    from scrabblegan.config import Config, SharedSpecs, config_to_dict
    from scrabblegan.train.state import build_models
    from scrabblegan.utils.fakeparams import fake_variables
    from scrabblegan.utils.flops import matmul_flops_cached

    cfg = Config(shared=dataclasses.replace(
        SharedSpecs(), batch_size=batch, z_source="noise", dtype="bfloat16"))
    generator = build_models(cfg).generator
    labels = jnp.zeros((batch, length), jnp.int32)
    z0 = jax.random.normal(jax.random.PRNGKey(0), (batch, cfg.shared.latent_dim))
    # throughput bench: param VALUES are irrelevant — build the tree from
    # eval_shape with numerically-sane fakes (orthogonal QRs would dominate)
    shapes = jax.eval_shape(lambda: generator.init(
        jax.random.PRNGKey(0), labels, z=z0, train=False))
    variables = jax.device_put(fake_variables(shapes))

    @jax.jit
    def timed_chain(variables, labels, z):
        def body(carry_z, _):
            out = generator.apply(variables, labels, z=carry_z, train=False)
            # dependency: fold a negligible function of the output back in
            carry_z = carry_z + jnp.mean(out).astype(carry_z.dtype) * 1e-8
            return carry_z, out[0, 0, 0, 0]
        return jax.lax.scan(body, z, None, length=iters)

    t0 = time.time()
    fz, probes = timed_chain(variables, labels, z0)
    _ = float(fz[0, 0]), float(probes[-1])  # device->host fetch = hard sync
    log(f"len {length}: compile+first chain: {time.time() - t0:.1f}s")

    best = None
    for rep in range(3):
        t0 = time.time()
        fz, probes = timed_chain(variables, labels, z0)
        _ = float(fz[0, 0]), float(probes[-1])
        dt = time.time() - t0
        log(f"len {length} rep {rep}: {iters} fwd in {dt:.3f}s -> "
            f"{batch * iters / dt:,.0f} img/s")
        best = dt if best is None else min(best, dt)

    # analytic FLOPs of ONE forward batch (traced, not compiled); the jaxpr
    # holds both attention branches and the counter takes the reference's
    fwd_flops = matmul_flops_cached(
        lambda v, l, z: generator.apply(v, l, z=z, train=False),
        shapes, labels, z0,
        salt="inference|" + json.dumps(config_to_dict(cfg), sort_keys=True),
        cache_path=_FLOPS_CACHE)
    img_s = batch * iters / best
    mfu = _mfu(img_s * fwd_flops / batch)
    log(f"len {length}: {fwd_flops / batch / 1e9:.2f} GFLOP/img -> MFU {mfu}")
    return img_s, mfu


def _trainer_cfg(length):
    """The config the e2e Trainer runs (modulo loop-only io.* knobs), so the
    e2e Trainer receives the raw section's compiled step via the
    make_parallel_train_step process memo. trunk_dtype='bfloat16' is the
    recommended configuration (configs/recommended.json)."""
    from scrabblegan.config import load_config

    return load_config(None, {"shared.batch_size": 16, "io.seq_len": length,
                              "shared.num_gen": 4,
                              "shared.trunk_dtype": "bfloat16"})


def bench_train_step(length=5):
    """Raw device step rate: full 4-network train step at the reference schedule
    (batch 16 — scrabble_gan.gin:18) on a device-resident batch, constructed as
    the Trainer constructs it (make_parallel_train_step over a 1-device mesh,
    uint8 wire batches, donated state). Each timed step consumes the previous
    step's state. Returns (steps/s, MFU)."""
    import jax
    import numpy as np

    from scrabblegan.config import config_to_dict
    from scrabblegan.parallel.mesh import (batch_sharding, make_mesh,
                                           make_parallel_train_step)
    from scrabblegan.train.state import build_models, create_train_state
    from scrabblegan.train.step import make_train_step
    from scrabblegan.utils.fakeparams import fake_variables
    from scrabblegan.utils.flops import matmul_flops_cached

    cfg = _trainer_cfg(length)
    models = build_models(cfg)
    b = cfg.shared.batch_size
    shapes = jax.eval_shape(
        lambda: create_train_state(cfg, jax.random.PRNGKey(0), models))
    rng = np.random.default_rng(0)
    np_batch = {
        "real_imgs": rng.integers(0, 256, (b, 32, 16 * length, 1)).astype(np.uint8),
        "real_labels": rng.integers(0, 52, (b, length)).astype(np.int32),
        "style_imgs": rng.integers(0, 256, (b, 32, 160, 1)).astype(np.uint8),
        "fake_labels": rng.integers(0, 52, (b, length)).astype(np.int32),
    }
    mesh = make_mesh(cfg.parallel.num_devices, cfg.parallel.model_parallel)
    state = jax.device_put(fake_variables(shapes))
    batch = jax.device_put(np_batch, batch_sharding(mesh))

    step = make_parallel_train_step(cfg, models, mesh)
    t0 = time.time()
    state, m = step(state, batch, jax.random.PRNGKey(1))
    _ = float(m["d_loss"])
    log(f"len {length}: train step compile+first: {time.time() - t0:.1f}s")
    n, dt = 30, None
    for _rep in range(3):
        t0 = time.time()
        for i in range(n):
            state, m = step(state, batch, jax.random.PRNGKey(i))
        _ = float(m["d_loss"])  # the last step depends on every prior state
        dt = min(dt or 1e9, time.time() - t0)

    # analytic FLOPs of the WHOLE step (fwd + bwd: autodiff is inside the
    # traced function)
    step_flops = matmul_flops_cached(
        make_train_step(cfg, models), shapes, np_batch, jax.random.PRNGKey(0),
        salt="train|" + json.dumps(config_to_dict(cfg), sort_keys=True),
        cache_path=_FLOPS_CACHE)
    mfu = _mfu(n / dt * step_flops)
    log(f"len {length}: {n} train steps in {dt:.3f}s -> {n / dt:.2f} steps/s "
        f"(batch {b}), {step_flops / 1e9:.1f} GFLOP/step, MFU {mfu}")
    return n / dt, mfu


def bench_trainer_e2e() -> float:
    """END-TO-END trainer rate: the real Trainer loop — host batch assembly,
    prefetch thread, H2D transfer, metrics fetch, logging — on synthetic data
    at the raw bench's shape (batch 16, len 5). Three epochs; epoch 1 pays the
    compiles and the rate is the best warm epoch (last_epoch_secs covers only
    the batch loop). No full-state checkpoint and no export gate: bench
    measures throughput, not the persistence plumbing (tests cover it)."""
    import shutil

    from scrabblegan.data.synthetic import make_synthetic_dataset
    from scrabblegan.train.loop import Trainer

    workdir = tempfile.mkdtemp(prefix="scrabblegan_bench_e2e_")
    try:
        cfg = _trainer_cfg(5)
        cfg = dataclasses.replace(cfg, io=dataclasses.replace(
            cfg.io, ckpt_every=0, export_quality_samples=0))
        read_dir, words_file, style_dir = make_synthetic_dataset(
            os.path.join(workdir, "data"), samples_per_bucket=64, bucket_size=5)
        trainer = Trainer(cfg, workdir=workdir, verbose=False)
        trainer.load_data(read_dir=read_dir, style_dir=style_dir,
                          words_file=words_file)
        bpe = 250
        t0 = time.time()
        trainer.train(epochs=3, batches_per_epoch=bpe, resume=False)
        warm = trainer.epoch_secs[1:]
        rate = bpe / min(warm)
        log(f"e2e 3 epochs in {time.time() - t0:.1f}s; warm epochs "
            f"{[round(s, 1) for s in warm]}s -> best {rate:.2f} steps/s")
        return rate
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main() -> int:
    import jax

    from scrabblegan.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU (devices: {jax.devices()})", file=sys.stderr)
        return 1
    _CARD["line"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    enable_compilation_cache()
    _RESULT["extra"]["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                                  "count": len(jax.devices()),
                                  "card": _CARD["line"]}
    log(f"device: {dev}")

    def inf5():
        img_s, mfu = bench_inference(5, 50)
        _RESULT["value"] = round(img_s, 1)
        _RESULT["extra"]["mfu_inference_len5"] = mfu

    def train5():
        rate, mfu = bench_train_step(5)
        _RESULT["extra"]["train_steps_per_sec_batch16"] = round(rate, 2)
        _RESULT["extra"]["mfu_train_len5"] = mfu

    def e2e():
        rate = bench_trainer_e2e()
        _RESULT["extra"]["train_steps_per_sec_e2e"] = round(rate, 2)
        raw = _RESULT["extra"].get("train_steps_per_sec_batch16")
        if raw:
            _RESULT["extra"]["e2e_over_raw"] = round(rate / raw, 3)

    def inf10():
        img_s, mfu = bench_inference(10, 30)
        _RESULT["extra"]["images_per_sec_len10"] = round(img_s, 1)
        _RESULT["extra"]["mfu_inference_len10"] = mfu

    def train10():
        rate, mfu = bench_train_step(10)
        _RESULT["extra"]["train_steps_per_sec_len10"] = round(rate, 2)
        _RESULT["extra"]["mfu_train_len10"] = mfu

    failed = []
    for name, section in (("inference_len5", inf5), ("train_len5", train5),
                          ("e2e", e2e), ("inference_len10", inf10),
                          ("train_len10", train10)):
        try:
            section()
        except Exception:  # noqa: BLE001 — report, keep measuring, fail at exit
            import traceback

            traceback.print_exc(file=sys.stderr)
            failed.append(name)
        emit()
    if failed:
        _RESULT["extra"]["failed_sections"] = failed
        emit()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

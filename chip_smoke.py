#!/usr/bin/env python
"""Smoke test of the train and inference path on one NVIDIA GPU.

    python chip_smoke.py                # every phase below, on one card
    python chip_smoke.py --four-cards   # only the data-parallel check, 4 cards

Everything runs in this one process (a JAX process reserves most of a card's
memory). Phases, each printing its own lines and failing the run if it fails:

  a  environment: the card's name and power limit, versions, devices, and
     which optional packages import;
  b  the fused attention kernel against the plain XLA version at the real
     attention widths, in f32 and bf16, with both timed;
  c  the generator forward on the card against the host CPU backend (batch 8,
     word length 10) under default and "highest" matmul precision;
  d  the train step's compile (cold, then warm from the persistent compile
     cache) and memory analysis; `train.py --synthetic` for two epochs, a
     resumed third epoch from its checkpoint; `infer.py` on the export;
  e  the generator forward at batch 1024, word length 10, bf16, with its
     memory analysis beside that of the plain-attention version.

The last line of standard output is one JSON object: {"ok": true, "device":
{...}}. Without a GPU the script exits non-zero before printing it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# attention sites (Q, K) at full width: generator block B3 at word lengths 5
# and 10, style encoder and discriminator block B1 on the 160 px canvas
ATTENTION_SITES = {"G_len5": (2560, 640), "G_len10": (5120, 1280),
                   "D_style": (1280, 320)}
# kernel vs plain XLA at batch 64, |diff| <= tol * (1 + |xla|). f32: scores
# at full f32 in both, value product in TF32 in both, summed in different
# orders. bf16: both round the softmax weights and the output to bf16 (one
# output ulp is 2^-8 relative), at different points.
ATTENTION_TOL = {"float32": 5e-3, "bfloat16": 2e-2}
# generator on the card vs the CPU backend, max |diff| of tanh outputs: under
# default precision the card may run f32 convolutions and matmuls in TF32
G_TOL = {"default": 1e-2, "highest": 1e-4}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def timed(fn, *args, reps: int = 10) -> float:
    """Median seconds of fn(*args) after one warm-up call."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    gb = 1e9
    return (f"args {m.argument_size_in_bytes / gb:.3f} GB, outputs "
            f"{m.output_size_in_bytes / gb:.3f} GB, temp "
            f"{m.temp_size_in_bytes / gb:.3f} GB, aliased "
            f"{m.alias_size_in_bytes / gb:.3f} GB")


# ------------------------------------------------------------------ phases
def phase_environment():
    import jax
    import jaxlib

    log(f"[a] card: {card_line()}")
    log(f"[a] jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"python {sys.version.split()[0]}")
    log(f"[a] devices: {jax.devices()}")
    found = {}
    for name in ("flax", "orbax.checkpoint", "matplotlib", "imageio", "cv2", "PIL"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    log(f"[a] optional packages importable: {found}")


def phase_attention():
    import jax
    import jax.numpy as jnp

    from scrabblegan.kernels.attention import (nonlocal_attention,
                                               reference_attention)

    kernel = jax.jit(nonlocal_attention)
    plain = jax.jit(reference_attention)
    for dtype in (jnp.float32, jnp.bfloat16):
        name = jnp.dtype(dtype).name
        for site, (q, k) in ATTENTION_SITES.items():
            keys = jax.random.split(jax.random.PRNGKey(len(site)), 3)
            args = (jax.random.normal(keys[0], (64, q, 8), jnp.float32).astype(dtype),
                    jax.random.normal(keys[1], (64, k, 8), jnp.float32).astype(dtype),
                    jax.random.normal(keys[2], (64, k, 32), jnp.float32).astype(dtype))
            hlo = kernel.lower(*args).compile().as_text()
            if "triton" not in hlo:
                raise RuntimeError(f"attention {site} {name}: no Triton kernel "
                                   f"in the compiled program")
            got = kernel(*args).astype(jnp.float32)
            ref = plain(*args).astype(jnp.float32)
            err = float(jnp.max(jnp.abs(got - ref) / (1 + jnp.abs(ref))))
            t_k, t_p = timed(kernel, *args), timed(plain, *args)
            log(f"[b] attention {site} B=64 Q={q} K={k} {name}: max|kernel-xla|/"
                f"(1+|xla|) {err:.2e} (tol {ATTENTION_TOL[name]:.0e}); kernel "
                f"{t_k * 1e3:.3f} ms, xla {t_p * 1e3:.3f} ms")
            if not err <= ATTENTION_TOL[name]:
                raise AssertionError(f"attention {site} {name}: error {err}")


def phase_generator_vs_cpu():
    import jax
    import jax.numpy as jnp

    from scrabblegan.config import Config
    from scrabblegan.train.state import build_models
    from scrabblegan.utils.fakeparams import fake_variables

    cfg = Config()
    gen = build_models(cfg).generator
    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(0)
    labels = rng.integers(0, cfg.io.n_classes, (8, 10)).astype(np.int32)
    style = rng.uniform(-1, 1, (8, 32, 160, 1)).astype(np.float32)
    shapes = jax.eval_shape(lambda: gen.init(jax.random.PRNGKey(0), labels,
                                             style_imgs=style, train=False))
    variables = jax.tree.map(np.asarray, fake_variables(shapes))
    fwd = jax.jit(lambda v, l, s: gen.apply(v, l, style_imgs=s, train=False))
    for precision in ("default", "highest"):
        with jax.default_matmul_precision(precision):
            on_card = np.asarray(fwd(*jax.device_put((variables, labels, style),
                                                    jax.devices()[0])))
            on_cpu = np.asarray(fwd(*jax.device_put((variables, labels, style), cpu)))
        err = float(np.max(np.abs(on_card - on_cpu)))
        log(f"[c] generator B=8 L=10 f32, {precision} precision: card vs cpu "
            f"max|diff| {err:.2e} (tol {G_TOL[precision]:.0e}), output "
            f"{on_card.shape}, finite {bool(np.isfinite(on_card).all())}")
        if not (np.isfinite(on_card).all() and err <= G_TOL[precision]):
            raise AssertionError(f"generator card vs cpu ({precision}): {err}")


def _compile_train_step(workdir: str, data):
    """Cold then warm compile of the train step exactly as the Trainer builds
    it under configs/recommended.json."""
    import jax

    from scrabblegan.config import load_config
    from scrabblegan.train.loop import Trainer
    from scrabblegan.train.state import create_train_state

    cfg = load_config(os.path.join(ROOT, "configs", "recommended.json"))
    trainer = Trainer(cfg, workdir=workdir, verbose=False)
    trainer.load_data(read_dir=data[0], words_file=data[1], style_dir=data[2])
    batch = trainer.next_batch()
    shapes = jax.eval_shape(lambda: create_train_state(
        cfg, jax.random.PRNGKey(cfg.seed), trainer.models))
    times = []
    for _ in range(2):
        jax.clear_caches()  # the second compile can only come from the disk cache
        t0 = time.perf_counter()
        compiled = trainer.step_fn.lower(shapes, batch, jax.random.PRNGKey(0)).compile()
        times.append(time.perf_counter() - t0)
    log(f"[d] train step (recommended config, batch {cfg.shared.batch_size}, "
        f"batch shapes { {k: tuple(v.shape) for k, v in batch.items()} }): "
        f"compile cold {times[0]:.1f} s, warm {times[1]:.1f} s, compile cache "
        f"{jax.config.jax_compilation_cache_dir}")
    log(f"[d] train step memory: {memory_line(compiled)}")


def phase_train_resume_infer():
    import infer
    import train
    from scrabblegan.data.synthetic import make_synthetic_dataset
    from scrabblegan.train.checkpoint import latest_generator_export
    from scrabblegan.utils.cache import enable_compilation_cache
    from scrabblegan.utils.png import read_png

    enable_compilation_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        data = make_synthetic_dataset(os.path.join(tmp, "data"))
        _compile_train_step(os.path.join(tmp, "compile_check"), data)

        work = os.path.join(tmp, "run")
        common = ["--synthetic", "--workdir", work, "--batches-per-epoch", "3"]
        t0 = time.perf_counter()
        if train.main(common + ["--epochs", "2"]) != 0:
            raise RuntimeError("train.py failed")
        log(f"[d] train.py 2 epochs x 3 steps: {time.perf_counter() - t0:.1f} s")
        steps = sorted(int(d) for d in os.listdir(os.path.join(work, "checkpoints"))
                       if d.isdigit())
        if steps[-1:] != [6]:
            raise AssertionError(f"expected a checkpoint at step 6, found {steps}")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train.main(common + ["--epochs", "3"])
        sys.stdout.write(out.getvalue())
        if rc != 0 or "resumed from checkpoint at step 6" not in out.getvalue():
            raise AssertionError("train.py did not resume from step 6")
        log(f"[d] resumed at step 6 and trained epoch 3: "
            f"{time.perf_counter() - t0:.1f} s")
        with open(os.path.join(work, "output", "batch_summary.csv")) as f:
            rows = [r.split(",") for r in f.read().strip().splitlines()[1:]]
        values = np.asarray([[float(x) for x in r[2:]] for r in rows])
        if len(rows) != 9 or not np.isfinite(values).all():
            raise AssertionError(f"{len(rows)} metric rows, finite "
                                 f"{np.isfinite(values).all()}")
        log(f"[d] 9 train steps logged, all metrics finite; last row {rows[-1]}")

        word = "scrabbled"
        png = os.path.join(tmp, "infer.png")
        if infer.main(["--model-dir", os.path.join(work, "model"), "--word", word,
                       "-n", "4", "--out", png]) != 0:
            raise RuntimeError("infer.py failed")
        img = read_png(png)
        want = (4 * (32 + 4) + 4, 16 * len(word) + 8)  # 4 tiles + gutters
        if img.shape != want:
            raise AssertionError(f"infer grid {img.shape}, want {want}")
        log(f"[d] infer.py served {latest_generator_export(os.path.join(work, 'model'))}:"
            f" 4 samples of {word!r}, each 32x{16 * len(word)} px")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_big_batch():
    import jax
    import jax.numpy as jnp

    from scrabblegan.config import Config, SharedSpecs
    from scrabblegan.train.state import build_models
    from scrabblegan.utils.fakeparams import fake_variables

    cfg = Config(shared=dataclasses.replace(SharedSpecs(), dtype="bfloat16",
                                            z_source="noise"))
    labels = jnp.zeros((1024, 10), jnp.int32)
    z = jax.random.normal(jax.random.PRNGKey(0), (1024, cfg.shared.latent_dim))
    for use_kernel in (False, True):
        gen = build_models(cfg, use_pallas_attention=use_kernel).generator
        fwd = jax.jit(lambda v, l, z: gen.apply(v, l, z=z, train=False))
        shapes = jax.eval_shape(lambda: gen.init(jax.random.PRNGKey(0), labels,
                                                 z=z, train=False))
        t0 = time.perf_counter()
        compiled = fwd.lower(shapes, labels, z).compile()
        name = "kernel" if use_kernel else "plain XLA"
        log(f"[e] generator B=1024 L=10 bf16, {name} attention: compiled in "
            f"{time.perf_counter() - t0:.1f} s; memory: {memory_line(compiled)}")
    variables = jax.device_put(fake_variables(shapes))
    out = compiled(variables, labels, z)
    t = timed(compiled, variables, labels, z, reps=5)
    out = np.asarray(out.astype(jnp.float32))
    if out.shape != (1024, 32, 160, 1) or not np.isfinite(out).all():
        raise AssertionError(f"big-batch output {out.shape}, finite "
                             f"{np.isfinite(out).all()}")
    log(f"[e] generator B=1024 L=10 bf16 with the kernel: output {out.shape}, "
        f"finite, {t * 1e3:.1f} ms per call ({1024 / t:.0f} images/s)")


def phase_four_cards(global_batch: int = 16):
    """One train step at global batch 16, data-parallel with FSDP on four
    cards, against the same step from the same state on one card."""
    import jax

    from scrabblegan.config import load_config
    from scrabblegan.parallel.mesh import (batch_sharding, make_mesh,
                                           make_parallel_train_step,
                                           state_sharding_for)
    from scrabblegan.train.state import build_models, create_train_state

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four-cards needs 4 devices, found {jax.devices()}")
    cfg = load_config(os.path.join(ROOT, "configs", "recommended.json"),
                      {"shared.batch_size": global_batch})
    models = build_models(cfg)
    state = jax.device_get(create_train_state(cfg, jax.random.PRNGKey(0), models))
    shapes = jax.eval_shape(lambda: state)
    rng = np.random.default_rng(0)
    n, length = global_batch, 10
    batch = {
        "real_imgs": rng.integers(0, 256, (n, 32, 16 * length, 1)).astype(np.uint8),
        "real_labels": rng.integers(0, 52, (n, length)).astype(np.int32),
        "real_lengths": rng.integers(1, length + 1, (n,)).astype(np.int32),
        "style_imgs": rng.integers(0, 256, (n, 32, 160, 1)).astype(np.uint8),
        "fake_labels": rng.integers(0, 52, (n, length)).astype(np.int32),
        "fake_lengths": rng.integers(1, length + 1, (n,)).astype(np.int32),
    }
    results = {}
    for cards, fsdp in ((4, True), (1, False)):
        run_cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, num_devices=cards, fsdp=fsdp))
        mesh = make_mesh(cards)
        step = make_parallel_train_step(run_cfg, models, mesh, donate=False,
                                        state_shapes=shapes)
        st = jax.device_put(state, state_sharding_for(run_cfg, mesh, shapes))
        t0 = time.perf_counter()
        new_state, metrics = step(st, jax.device_put(batch, batch_sharding(mesh)),
                                  jax.random.PRNGKey(1))
        metrics = {k: float(v) for k, v in jax.device_get(metrics).items()}
        log(f"[4] {cards} card(s), fsdp={fsdp}: first step (compile included) "
            f"{time.perf_counter() - t0:.1f} s; metrics {metrics}")
        results[cards] = (metrics, jax.device_get(new_state.g_params))
    (m4, g4), (m1, g1) = results[4], results[1]
    worst = max(abs(m4[k] - m1[k]) / max(1.0, abs(m1[k])) for k in m1)
    g_err = max(float(np.max(np.abs(np.asarray(a) - np.asarray(b))))
                for a, b in zip(jax.tree.leaves(g4), jax.tree.leaves(g1)))
    # the first Adam step moves each param by ~lr * sign(grad), so a near-zero
    # gradient whose sign differs between the runs gives |diff| up to 2 * lr
    log(f"[4] 4 cards (DP + FSDP) vs 1 card: worst metric difference "
        f"{worst:.2e} (tol 2e-2, relative above 1), max |updated G param diff| "
        f"{g_err:.2e} (tol 1e-3; sign flips of near-zero gradients give up to "
        f"2 x lr = 4e-4)")
    if not (worst <= 2e-2 and g_err <= 1e-3):
        raise AssertionError("four-card step disagrees with one card")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--four-cards", action="store_true",
                   help="run only the data-parallel check on four cards")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU found (devices: {devices})", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    if args.four_cards:
        phase_environment()
        phase_four_cards()
    else:
        for key, phase in (("a", phase_environment), ("b", phase_attention),
                           ("c", phase_generator_vs_cpu),
                           ("d", phase_train_resume_infer), ("e", phase_big_batch)):
            t0 = time.perf_counter()
            phase()
            log(f"[{key}] phase done in {time.perf_counter() - t0:.1f} s")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end training-loop tests on the synthetic dataset fixture: a real (tiny)
Trainer.train() run producing metrics files, sample grids, checkpoints, a
generator export — then checkpoint RESUME and the offline plotter."""

import dataclasses
import os

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits multi-network steps / fresh model shapes

from scrabblegan.config import Config, IOConfig, OptimizerConfig, ParallelConfig, SharedSpecs
from scrabblegan.data.synthetic import make_synthetic_dataset

B = 4


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("run"))


@pytest.fixture(scope="module")
def cfg():
    return Config(
        optimizer=OptimizerConfig(),
        shared=dataclasses.replace(SharedSpecs(), batch_size=B, num_gen=4),
        io=dataclasses.replace(IOConfig(), bucket_size=3),
        parallel=ParallelConfig(num_devices=1),
    )


@pytest.fixture(scope="module")
def data_paths(tmp_path_factory):
    data_root = str(tmp_path_factory.mktemp("data"))
    return make_synthetic_dataset(data_root, samples_per_bucket=4, bucket_size=3)


@pytest.fixture(scope="module")
def trained(cfg, workdir, data_paths):
    from scrabblegan.train.loop import Trainer

    read_dir, words_file, style_dir = data_paths
    trainer = Trainer(cfg, workdir=workdir, verbose=False)
    trainer.load_data(read_dir=read_dir, style_dir=style_dir, words_file=words_file)
    state = trainer.train(epochs=1, batches_per_epoch=2, resume=False)
    return trainer, state


class TestTrainRun:
    def test_metrics_files(self, trained, workdir):
        trainer, _ = trained
        out = trainer.gen_path
        for fn in ("batch_summary.txt", "epoch_summary.txt", "batch_summary.csv"):
            assert os.path.exists(os.path.join(out, fn)), fn
        lines = open(os.path.join(out, "batch_summary.txt")).read().strip().split("\n")
        assert len(lines) == 1 + 2  # header + 2 batches
        assert lines[0].count(";") == 15  # 16 columns

    def test_epoch_grid_and_gif(self, trained):
        trainer, _ = trained
        assert os.path.exists(os.path.join(trainer.gen_path, "image_at_epoch_0001.png"))
        assert os.path.exists(os.path.join(trainer.gen_path, "biggan.png"))

    def test_generator_export(self, trained):
        trainer, state = trained
        from scrabblegan.train.checkpoint import latest_generator_export, load_generator

        export = latest_generator_export(trainer.model_path)
        assert export is not None
        variables = load_generator(export)
        assert "params" in variables and "batch_stats" in variables

    def test_state_advanced(self, trained):
        _, state = trained
        assert int(state.step) == 2

    def test_recognizer_export(self, trained):
        """Reference parity (data_utils.py:346-348): R weights save alongside
        G every epoch, so the rFID/CER extractor can be rebuilt from any epoch
        without the full-state checkpoint."""
        trainer, state = trained
        from scrabblegan.train.checkpoint import (
            latest_recognizer_export,
            load_recognizer,
        )

        export = latest_recognizer_export(trainer.model_path)
        assert export is not None
        variables = load_recognizer(export)
        assert "params" in variables and "batch_stats" in variables
        # the exported R must actually run: logits (B, 4*len-1, n_classes+1)
        imgs = np.zeros((2, 32, 16 * 3, 1), np.float32)
        logits = trainer.models.recognizer.apply(variables, imgs, train=False)
        assert logits.shape == (2, 4 * 3 - 1, 53)

    def test_ckpt_every_zero_disables_full_state_saves(self, trained):
        """io.ckpt_every=0: no full-state checkpoint even on the final epoch
        (bench.py's e2e section); exports still written."""
        trainer, state = trained
        before = set(os.listdir(trainer.ckpt_path))
        saved_cfg = trainer.cfg
        try:
            trainer.cfg = dataclasses.replace(
                saved_cfg, io=dataclasses.replace(saved_cfg.io, ckpt_every=0,
                                                  export_quality_samples=0))
            trainer.save_epoch_artifacts(state, epoch=7, final=True)
        finally:
            trainer.cfg = saved_cfg
        assert set(os.listdir(trainer.ckpt_path)) == before  # no new ckpt
        # the G export for epoch 7 still landed
        assert os.path.isdir(os.path.join(trainer.model_path, "generator", "7"))

    def test_export_quality_gate(self, trained):
        """VERDICT r4 item 5: every export gets a calibrated rfid_rand flag
        file, and latest_good tracks the newest non-suspect epoch."""
        import json

        trainer, _ = trained
        path = os.path.join(trainer.model_path, "generator", "quality_1.json")
        assert os.path.exists(path)
        with open(path) as f:
            res = json.load(f)
        assert res["flag"] in ("ok", "suspect")
        assert res["metric"] == "rfid_rand"
        from scrabblegan.eval import latest_good_export

        lg = latest_good_export(trainer.model_path)
        if res["flag"] == "ok":
            assert lg is not None and lg.endswith(os.sep + "1")
        else:
            assert lg is None

    def test_workdir_is_self_describing(self, trained, cfg, workdir):
        """config.json lands in the workdir, checkpoint dir, and model dir and
        round-trips to the exact training config (VERDICT r2 item 2)."""
        trainer, _ = trained
        from scrabblegan.config import load_config

        for d in (workdir, trainer.ckpt_path, trainer.model_path):
            path = os.path.join(d, "config.json")
            assert os.path.exists(path), path
            assert load_config(path) == cfg

    def test_infer_bare_on_padded_ema_export(self, cfg, tmp_path_factory):
        """THE self-describing-checkpoint case (VERDICT r2 item 2): a padded
        shape-mode + EMA run's export has a different param tree (filter-bank
        PAD row), which used to require a manual
        `--set parallel.shape_mode=padded` or the restore failed with a tree
        mismatch. With config.json discovery, bare infer must work."""
        import jax

        import infer
        from scrabblegan.train import checkpoint as ckpt_lib
        from scrabblegan.train.loop import Trainer
        from scrabblegan.train.state import create_train_state
        from scrabblegan.utils.fakeparams import fake_variables

        padded_cfg = dataclasses.replace(
            cfg,
            parallel=dataclasses.replace(cfg.parallel, shape_mode="padded"),
            optimizer=dataclasses.replace(cfg.optimizer, g_ema_decay=0.999))
        workdir = str(tmp_path_factory.mktemp("padded_run"))
        trainer = Trainer(padded_cfg, workdir=workdir, verbose=False)
        # fabricate an export without training: the structure is what matters
        shapes = jax.eval_shape(lambda: create_train_state(
            padded_cfg, jax.random.PRNGKey(0), trainer.models))
        state = fake_variables(shapes)
        assert state.g_ema is not None  # EMA tree present in this config
        ckpt_lib.save_generator(trainer.model_path, state.g_ema,
                                state.g_stats, 1)
        out = str(tmp_path_factory.mktemp("infer") / "bare.png")
        rc = infer.main(["--model-dir", trainer.model_path, "--word", "ab",
                         "-n", "1", "--out", out])
        assert rc == 0 and os.path.exists(out)

    def test_resume_from_checkpoint(self, trained, cfg, workdir):
        """Restart must pick up the saved step (fixes SURVEY.md defect #6)."""
        trainer, state = trained
        restored = trainer.init_state(resume=True)
        assert int(restored.step) == int(state.step)
        leaves_a = [np.asarray(x) for x in
                    __import__("jax").tree_util.tree_leaves(state.g_params)]
        leaves_b = [np.asarray(x) for x in
                    __import__("jax").tree_util.tree_leaves(restored.g_params)]
        for a, b in zip(leaves_a, leaves_b):
            np.testing.assert_array_equal(a, b)

    def test_plotter_consumes_loop_output(self, trained):
        """Fixes SURVEY.md defect #9: utilities must read the loop's own CSV."""
        trainer, _ = trained
        from scrabblegan.utils.plotting import plot_losses

        outs = plot_losses(trainer.gen_path, info_per_batch=True)
        assert len(outs) == 4
        for o in outs:
            assert os.path.exists(o)

    def test_train_noise_mode_epoch_artifacts(self, cfg, tmp_path_factory):
        """z_source='noise' must survive a full epoch INCLUDING the epoch-end
        artifact dump (grid + checkpoint) — configs 2/3 set this mode and the
        round-1 build crashed in save_epoch_artifacts (no seed z)."""
        from scrabblegan.train.loop import Trainer

        noise_cfg = dataclasses.replace(
            cfg, shared=dataclasses.replace(cfg.shared, z_source="noise"))
        workdir = str(tmp_path_factory.mktemp("run_noise"))
        data_root = str(tmp_path_factory.mktemp("data_noise"))
        read_dir, words_file, style_dir = make_synthetic_dataset(
            data_root, samples_per_bucket=4, bucket_size=3)
        trainer = Trainer(noise_cfg, workdir=workdir, verbose=False)
        trainer.load_data(read_dir=read_dir, style_dir=style_dir,
                          words_file=words_file)
        state = trainer.train(epochs=1, batches_per_epoch=1, resume=False)
        assert int(state.step) == 1
        assert os.path.exists(
            os.path.join(trainer.gen_path, "image_at_epoch_0001.png"))

    def test_sync_pipeline_matches_prefetched(self, cfg, tmp_path_factory):
        """prefetch_depth=0 (synchronous host path) must produce the same
        batch stream as the default background prefetcher — both draw from the
        same np_rng sequence."""
        from scrabblegan.train.loop import Trainer, _Prefetcher

        data_root = str(tmp_path_factory.mktemp("data_sync"))
        read_dir, words_file, style_dir = make_synthetic_dataset(
            data_root, samples_per_bucket=4, bucket_size=3)

        def batches(depth):
            t = Trainer(cfg, workdir=str(tmp_path_factory.mktemp("wd")),
                        verbose=False)
            t.load_data(read_dir=read_dir, style_dir=style_dir,
                        words_file=words_file)
            if depth == 0:
                return [np.asarray(t._assemble()["real_imgs"])
                        for _ in range(4)]
            pf = _Prefetcher(lambda: t._assemble(), depth=depth)
            try:
                return [np.asarray(pf.get()["real_imgs"]) for _ in range(4)]
            finally:
                pf.close()

        for a, b in zip(batches(0), batches(2)):
            np.testing.assert_array_equal(a, b)

    def test_prefetcher_propagates_errors(self):
        from scrabblegan.train.loop import _Prefetcher

        def boom():
            raise ValueError("producer failed")

        pf = _Prefetcher(boom, depth=2)
        with pytest.raises(ValueError, match="producer failed"):
            pf.get()
        pf.close()

    def test_divergence_guard_stops_run(self, trained, cfg, tmp_path_factory):
        """A non-finite metric must stop the loop (diverged_at set) without
        saving the poisoned state as that epoch's artifacts."""
        import jax.numpy as jnp

        from scrabblegan.train.loop import Trainer

        src_trainer, state = trained
        workdir = str(tmp_path_factory.mktemp("run_nan"))
        trainer = Trainer(cfg, workdir=workdir, verbose=False)
        # reuse the trained fixture's loaded data and state; fake a step fn
        # that returns NaN metrics on the second call
        for attr in ("dataset", "style_train", "style_validate", "random_words",
                     "seed_style", "seed_labels", "seed_z"):
            if hasattr(src_trainer, attr):
                setattr(trainer, attr, getattr(src_trainer, attr))
        if getattr(trainer, "_u8", False):
            trainer._style_u8 = src_trainer._style_u8
        calls = [0]

        def fake_step(st, batch, rng):
            calls[0] += 1
            bad = jnp.float32(jnp.nan) if calls[0] >= 2 else jnp.float32(0.5)
            from scrabblegan.train.step import METRIC_NAMES

            return st, {name: bad for name in METRIC_NAMES}

        trainer.step_fn = fake_step
        trainer.init_state = lambda resume=True: state
        trainer.train(epochs=2, batches_per_epoch=3, resume=False)
        assert trainer.diverged_at is not None
        assert trainer.diverged_at[0] == 0  # first epoch
        # the poisoned epoch saved no artifacts
        assert not os.path.exists(
            os.path.join(trainer.gen_path, "image_at_epoch_0001.png"))

    def test_inference_on_export(self, trained, cfg):
        """infer.py path: word string -> images via the latest export."""
        trainer, _ = trained
        import infer

        out_png = os.path.join(trainer.gen_path, "inference_test.png")
        rc = infer.main([
            "--model-dir", trainer.model_path, "--word", "ab", "-n", "2",
            "--out", out_png,
        ])
        assert rc == 0
        assert os.path.exists(out_png)

    def test_evaluate_bucket_all_sweep(self, trained, workdir, data_paths,
                                       capsys):
        """evaluate.py --bucket all (VERDICT r3 item 5): one JSON line per
        nonempty bucket, each carrying rfid + cer_real + cer_gen — the
        length-generalization sweep the single-bucket eval lacked."""
        import json

        import evaluate

        read_dir, words_file, style_dir = data_paths
        rc = evaluate.main([
            "--workdir", workdir, "--read-dir", read_dir,
            "--style-dir", style_dir, "--words-file", words_file,
            "--bucket", "all", "--num-samples", "8",
        ])
        assert rc == 0
        rows = [json.loads(l) for l in capsys.readouterr().out.splitlines()
                if l.startswith("{")]
        assert [r["bucket"] for r in rows] == [1, 2, 3]
        for r in rows:
            for key in ("rfid", "cer_real", "cer_gen"):
                assert key in r and np.isfinite(r[key]), (r, key)
            # CER is edit_distance / target_len, which an undertrained R can
            # push past 1.0 via insertions (observed 1.125 on this 2-step
            # fixture) — bound by the decode's structural ceiling instead:
            # at most T = 4*len - 1 frames can each contribute one edit
            ceiling = (4 * r["bucket"] - 1) / r["bucket"]
            assert 0.0 <= r["cer_gen"] <= ceiling
            assert 0.0 <= r["cer_real"] <= ceiling

"""Trainer-level multi-device drive (VERDICT r3 item 6): the dryrun and the
parallel/ tests cover the bare step; this drives `Trainer.train` itself on the
virtual 8-CPU mesh under the composed fsdp+tp layout, INCLUDING a checkpoint save
of the SHARDED train state and a restore-on-start into a fresh Trainer —
resharding on restore is the classic multi-chip failure. A second restore into
a plain replicated-DP Trainer pins cross-layout resharding (checkpoint written
sharded, read replicated)."""

import dataclasses
import os

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # jits the 4-network fsdp+tp step

from scrabblegan.config import Config, IOConfig, ParallelConfig, SharedSpecs
from scrabblegan.data.synthetic import make_synthetic_dataset

B = 8  # one sample per virtual device on the (4, 2) grid


def _cfg(mp: int, fsdp: bool) -> Config:
    return Config(
        shared=dataclasses.replace(SharedSpecs(), batch_size=B, num_gen=4),
        # seq_len pins every batch to bucket 2 -> ONE step compilation
        io=dataclasses.replace(IOConfig(), bucket_size=3, seq_len=2),
        parallel=ParallelConfig(num_devices=8, model_parallel=mp, fsdp=fsdp),
    )


@pytest.fixture(scope="module")
def data_paths(tmp_path_factory):
    data_root = str(tmp_path_factory.mktemp("mdev_data"))
    return make_synthetic_dataset(data_root, samples_per_bucket=8,
                                  bucket_size=3)


@pytest.fixture(scope="module")
def sharded_run(data_paths, tmp_path_factory):
    """One epoch x 2 steps of Trainer.train under fsdp+tp; returns
    (workdir, final state)."""
    from scrabblegan.train.loop import Trainer

    read_dir, words_file, style_dir = data_paths
    workdir = str(tmp_path_factory.mktemp("mdev_run"))
    trainer = Trainer(_cfg(mp=2, fsdp=True), workdir=workdir, verbose=False)
    trainer.load_data(read_dir=read_dir, style_dir=style_dir,
                      words_file=words_file)
    state = trainer.train(epochs=1, batches_per_epoch=2, resume=False)
    return workdir, state


class TestTrainerFsdpTp:
    def test_state_is_actually_sharded(self, sharded_run):
        """The trained state must live in the composed layout: the filter
        bank (the largest weight) split across devices, not replicated."""
        _, state = sharded_run
        fb = state.g_params["filter_bank"]["filter_bank"]
        assert fb.sharding.shard_shape(fb.shape) != fb.shape
        v = state.g_opt[0].nu["filter_bank"]["filter_bank"]  # Adam moments co-shard
        assert v.sharding.shard_shape(v.shape) != v.shape

    def test_metrics_finite_and_artifacts(self, sharded_run):
        workdir, state = sharded_run
        assert int(jax.device_get(state.step)) == 2
        out = os.path.join(workdir, "output")
        assert os.path.exists(os.path.join(out, "batch_summary.txt"))
        assert os.path.exists(os.path.join(out, "image_at_epoch_0001.png"))

    def test_restore_sharded_same_layout(self, sharded_run, data_paths):
        """Fresh Trainer, same fsdp+tp layout: restore must come back sharded
        with identical values."""
        from scrabblegan.train.loop import Trainer

        workdir, state = sharded_run
        read_dir, words_file, style_dir = data_paths
        trainer2 = Trainer(_cfg(mp=2, fsdp=True), workdir=workdir,
                           verbose=False)
        trainer2.load_data(read_dir=read_dir, style_dir=style_dir,
                           words_file=words_file)
        restored = trainer2.init_state(resume=True)
        assert int(jax.device_get(restored.step)) == 2
        fb = restored.g_params["filter_bank"]["filter_bank"]
        assert fb.sharding.shard_shape(fb.shape) != fb.shape
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(fb)),
            np.asarray(jax.device_get(
                state.g_params["filter_bank"]["filter_bank"])))

    def test_restore_into_replicated_dp(self, sharded_run, data_paths,
                                        tmp_path_factory):
        """Cross-layout restore: a checkpoint written under fsdp+tp must load
        into a plain replicated-DP Trainer (values equal, layout replicated)."""
        import shutil

        from scrabblegan.train.loop import Trainer

        workdir, state = sharded_run
        # copy the checkpoint dir so the DP Trainer's config.json rewrite
        # can't disturb the sharded fixture's workdir
        workdir2 = str(tmp_path_factory.mktemp("mdev_dp"))
        shutil.copytree(os.path.join(workdir, "checkpoints"),
                        os.path.join(workdir2, "checkpoints"),
                        dirs_exist_ok=True)
        read_dir, words_file, style_dir = data_paths
        trainer_dp = Trainer(_cfg(mp=1, fsdp=False), workdir=workdir2,
                             verbose=False)
        trainer_dp.load_data(read_dir=read_dir, style_dir=style_dir,
                             words_file=words_file)
        restored = trainer_dp.init_state(resume=True)
        assert int(jax.device_get(restored.step)) == 2
        fb = restored.g_params["filter_bank"]["filter_bank"]
        assert fb.sharding.shard_shape(fb.shape) == fb.shape  # replicated now
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(fb)),
            np.asarray(jax.device_get(
                state.g_params["filter_bank"]["filter_bank"])))

    def test_restored_state_steps(self, sharded_run, data_paths):
        """LAST (it advances the workdir's checkpoint): a fresh fsdp+tp
        Trainer must resume from the sharded checkpoint and actually STEP.
        The restored step counter (2) places the run at start_epoch 2 of 3
        at batches_per_epoch=1, so exactly one more batch runs."""
        from scrabblegan.train.loop import Trainer

        workdir, _ = sharded_run
        read_dir, words_file, style_dir = data_paths
        trainer3 = Trainer(_cfg(mp=2, fsdp=True), workdir=workdir,
                           verbose=False)
        trainer3.load_data(read_dir=read_dir, style_dir=style_dir,
                           words_file=words_file)
        state = trainer3.train(epochs=3, batches_per_epoch=1, resume=True)
        assert int(jax.device_get(state.step)) == 3
        fb = state.g_params["filter_bank"]["filter_bank"]
        assert fb.sharding.shard_shape(fb.shape) != fb.shape

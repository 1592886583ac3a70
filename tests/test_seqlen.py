"""io.seq_len fixed-length sampling + io.log_every plumbing (fast: no step jit).

The reference exposes `io.seq_len` as a gin key (scrabble_gan.gin, default None);
configs/1_inference.json pins 5 for fixed-length runs. When set, every real and
fake batch must come from that single length bucket.
"""

import dataclasses

import numpy as np
import pytest

from scrabblegan.config import (
    Config, IOConfig, ParallelConfig, SharedSpecs, load_config,
)
from scrabblegan.data.synthetic import make_synthetic_dataset


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seqlen_data"))
    return make_synthetic_dataset(root, samples_per_bucket=4, bucket_size=3)


def _trainer(cfg, tmp_path_factory, data):
    from scrabblegan.train.loop import Trainer

    read_dir, words_file, style_dir = data
    t = Trainer(cfg, workdir=str(tmp_path_factory.mktemp("seqlen_run")),
                verbose=False)
    t.load_data(read_dir=read_dir, style_dir=style_dir, words_file=words_file)
    return t


class TestSeqLen:
    def test_assemble_pins_bucket(self, tmp_path_factory, data):
        cfg = Config(
            shared=dataclasses.replace(SharedSpecs(), batch_size=4, num_gen=2),
            io=dataclasses.replace(IOConfig(), bucket_size=3, seq_len=2),
            parallel=ParallelConfig(num_devices=1),
        )
        t = _trainer(cfg, tmp_path_factory, data)
        for _ in range(5):
            batch = t._assemble()
            assert batch["real_imgs"].shape[2] == 16 * 2  # width = 16px/char
            assert batch["real_labels"].shape[1] == 2
            assert batch["fake_labels"].shape[1] == 2
        # the fixed visualization seed uses the pinned length too
        assert t.seed_labels.shape[1] == 2

    def test_unset_varies_buckets(self, tmp_path_factory, data):
        cfg = Config(
            shared=dataclasses.replace(SharedSpecs(), batch_size=4, num_gen=2),
            io=dataclasses.replace(IOConfig(), bucket_size=3),
            parallel=ParallelConfig(num_devices=1),
        )
        t = _trainer(cfg, tmp_path_factory, data)
        widths = {t._assemble()["real_imgs"].shape[2] for _ in range(20)}
        assert len(widths) > 1  # draws from more than one bucket


class TestLogEvery:
    def test_override_plumbs_through(self):
        cfg = load_config(None, {"io.log_every": "1", "io.seq_len": "5"})
        assert int(cfg.io.log_every) == 1
        assert int(cfg.io.seq_len) == 5

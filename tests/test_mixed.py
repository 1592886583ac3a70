"""batch_mix='sample' (mixed-width padded batches): host-side assembly
semantics — per-sample length draws, per-sample pairing, pad fills. The step
itself is exercised in tests/test_padded.py (same compiled executable as
uniform-length batches; that IS the point of the mode)."""

import dataclasses

import numpy as np
import pytest

from scrabblegan.config import (
    Config,
    IOConfig,
    OptimizerConfig,
    ParallelConfig,
    SharedSpecs,
)
from scrabblegan.data.synthetic import make_synthetic_dataset

B = 8
L_MAX = 3


def mixed_cfg(**par):
    par.setdefault("num_devices", 1)
    par.setdefault("shape_mode", "padded")
    par.setdefault("batch_mix", "sample")
    return Config(
        optimizer=OptimizerConfig(),
        shared=dataclasses.replace(SharedSpecs(), batch_size=B),
        io=dataclasses.replace(IOConfig(), bucket_size=L_MAX),
        parallel=ParallelConfig(**par),
    )


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mixdata"))
    return make_synthetic_dataset(root, samples_per_bucket=6,
                                  bucket_size=L_MAX)


def make_trainer(cfg, data, tmp_path_factory):
    from scrabblegan.train.loop import Trainer

    read_dir, words_file, style_dir = data
    t = Trainer(cfg, workdir=str(tmp_path_factory.mktemp("mixwd")),
                verbose=False)
    t.load_data(read_dir=read_dir, style_dir=style_dir, words_file=words_file)
    return t


class TestMixedAssembly:
    def test_config_validation(self):
        from scrabblegan.train.loop import Trainer

        with pytest.raises(ValueError, match="padded"):
            Trainer(mixed_cfg(shape_mode="bucketed"), workdir="/tmp/x",
                    verbose=False)
        with pytest.raises(ValueError, match="batch_mix"):
            Trainer(mixed_cfg(batch_mix="shuffle"), workdir="/tmp/x",
                    verbose=False)

    def test_batch_mixes_lengths(self, data, tmp_path_factory):
        t = make_trainer(mixed_cfg(), data, tmp_path_factory)
        lengths = np.concatenate(
            [t._assemble()["real_lengths"] for _ in range(6)])
        assert lengths.min() >= 1 and lengths.max() <= L_MAX
        # 48 independent population-weighted draws over 3 equally-likely
        # buckets: P(all equal) ~ 3^-47 — a constant vector means the mix
        # never happened
        assert len(np.unique(lengths)) > 1

    def test_padding_and_labels(self, data, tmp_path_factory):
        t = make_trainer(mixed_cfg(), data, tmp_path_factory)
        b = t._assemble()
        h, _, c = t.cfg.io.input_dim
        w_max = 16 * L_MAX
        assert b["real_imgs"].shape == (B, h, w_max, c)
        assert b["real_imgs"].dtype == np.uint8  # uint8 wire format default
        for i in range(B):
            ln = int(b["real_lengths"][i])
            # beyond the true width the canvas is exactly white
            assert (b["real_imgs"][i, :, 16 * ln:] == 255).all()
            # labels beyond the true length carry the PAD id
            assert (b["real_labels"][i, ln:] == t.cfg.io.n_classes).all()
            assert (b["real_labels"][i, :ln] < t.cfg.io.n_classes).all()
            lf = int(b["fake_lengths"][i])
            assert (b["fake_labels"][i, lf:] == t.cfg.io.n_classes).all()
            assert (b["fake_labels"][i, :lf] < t.cfg.io.n_classes).all()

    def test_float32_wire_format_padding(self, data, tmp_path_factory):
        t = make_trainer(mixed_cfg(transfer_dtype="float32"), data,
                         tmp_path_factory)
        b = t._assemble()
        assert b["real_imgs"].dtype == np.float32
        i = 0
        ln = int(b["real_lengths"][i])
        np.testing.assert_allclose(b["real_imgs"][i, :, 16 * ln:], 1.0)
        assert b["real_imgs"].min() >= -1.0 and b["real_imgs"].max() <= 1.0

    def test_pairing_modes(self, data, tmp_path_factory):
        t = make_trainer(mixed_cfg(bucket_pairing="matched"), data,
                         tmp_path_factory)
        b = t._assemble()
        np.testing.assert_array_equal(b["fake_lengths"], b["real_lengths"])

        t2 = make_trainer(mixed_cfg(bucket_pairing="independent"), data,
                          tmp_path_factory)
        draws = [t2._assemble() for _ in range(6)]
        diff = sum(int((d["fake_lengths"] != d["real_lengths"]).sum())
                   for d in draws)
        assert diff > 0  # independent draws decouple the two length vectors

    def test_chunked_stacking(self, data, tmp_path_factory):
        t = make_trainer(mixed_cfg(steps_per_call=2), data, tmp_path_factory)
        stacked = t.next_batch()
        assert stacked["real_imgs"].shape[0] == 2
        assert stacked["real_imgs"].shape[1] == B
        assert stacked["real_lengths"].shape == (2, B)

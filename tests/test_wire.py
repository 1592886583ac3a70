"""uint8 host->device wire format (parallel.transfer_dtype) + metric stacking.

The e2e host pipeline ships image tensors as raw uint8 bytes (3.7x less H2D
traffic than float32) and normalizes on-device inside the jitted step with the
identical formula the host loaders use ((x - 127.5) / 127.5, loaders.py:121).
These tests pin the equivalence: real images are EXACT (they are uint8 on disk);
style images quantize by at most half a uint8 LSB.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from scrabblegan.config import Config, IOConfig, ParallelConfig, SharedSpecs
from scrabblegan.data.synthetic import make_synthetic_dataset
from scrabblegan.train.step import METRIC_NAMES, normalize_batch_images


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("wire_data"))
    return make_synthetic_dataset(root, samples_per_bucket=4, bucket_size=3)


def _trainer(transfer_dtype, tmp_path_factory, data, **io_kw):
    from scrabblegan.train.loop import Trainer

    cfg = Config(
        shared=dataclasses.replace(SharedSpecs(), batch_size=4, num_gen=2),
        io=dataclasses.replace(IOConfig(), bucket_size=3, **io_kw),
        parallel=dataclasses.replace(ParallelConfig(), num_devices=1,
                                     transfer_dtype=transfer_dtype),
    )
    read_dir, words_file, style_dir = data
    t = Trainer(cfg, workdir=str(tmp_path_factory.mktemp("wire_run")),
                verbose=False)
    t.load_data(read_dir=read_dir, style_dir=style_dir, words_file=words_file)
    return t


class TestUint8Wire:
    def test_normalize_matches_host_formula(self):
        u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
        host = (u8.astype(np.float32) - 127.5) / 127.5
        dev = normalize_batch_images({"real_imgs": jnp.asarray(u8)})["real_imgs"]
        np.testing.assert_array_equal(np.asarray(dev), host)

    def test_float_batches_pass_through(self):
        f32 = np.linspace(-1, 1, 64, dtype=np.float32).reshape(1, 8, 8, 1)
        out = normalize_batch_images({"real_imgs": jnp.asarray(f32),
                                      "real_labels": jnp.zeros((1, 2), jnp.int32)})
        np.testing.assert_array_equal(np.asarray(out["real_imgs"]), f32)
        assert out["real_labels"].dtype == jnp.int32

    def test_assemble_uint8_equals_float32_stream(self, tmp_path_factory, data):
        """Same seed -> the uint8 batch, normalized on-device, must reproduce
        the float32 batch exactly for real images and to <=0.5 LSB for style."""
        t8 = _trainer("uint8", tmp_path_factory, data)
        t32 = _trainer("float32", tmp_path_factory, data)
        for _ in range(3):
            b8 = normalize_batch_images(
                {k: jnp.asarray(v) for k, v in t8._assemble().items()})
            b32 = t32._assemble()
            np.testing.assert_array_equal(np.asarray(b8["real_imgs"]),
                                          b32["real_imgs"])
            np.testing.assert_array_equal(np.asarray(b8["real_labels"]),
                                          b32["real_labels"])
            np.testing.assert_allclose(np.asarray(b8["style_imgs"]),
                                       b32["style_imgs"], atol=0.5 / 127.5)

    def test_padded_mode_pads_white_in_uint8(self, tmp_path_factory, data):
        t8 = _trainer("uint8", tmp_path_factory, data)
        cfg = t8.cfg
        t8.cfg = dataclasses.replace(cfg, parallel=dataclasses.replace(
            cfg.parallel, shape_mode="padded"))
        batch = t8._assemble()
        assert batch["real_imgs"].dtype == np.uint8
        w_max = (cfg.io.input_dim[0] // 2) * cfg.io.bucket_size
        assert batch["real_imgs"].shape[2] == w_max
        # padded columns are white: 255 in uint8 == +1.0 after normalize
        lengths = batch["real_lengths"]
        for i, ln in enumerate(lengths):
            assert (batch["real_imgs"][i, :, 16 * ln:, :] == 255).all()


class TestMetricStacking:
    def test_stacked_rows_roundtrip(self):
        """The loop's on-device metric stacker (one fetch per block) must
        reproduce the per-step dict values in order."""
        import jax

        stack = jax.jit(lambda ms: jnp.stack(
            [jnp.stack([m[n] for n in METRIC_NAMES]) for m in ms]))
        dicts = [{n: jnp.float32(100 * i + j) for j, n in enumerate(METRIC_NAMES)}
                 for i in range(3)]
        got = np.asarray(stack(dicts))
        assert got.shape == (3, len(METRIC_NAMES))
        for i in range(3):
            for j, n in enumerate(METRIC_NAMES):
                assert got[i, j] == 100 * i + j

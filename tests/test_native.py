"""Native C++ batch-assembler tests: builds the library, checks numerics against
the numpy fallback, and exercises the BucketedDataset integration."""

import numpy as np
import pytest

from scrabblegan.data import native


@pytest.fixture(scope="module")
def lib():
    lib = native.load_library(build=True)
    if lib is None:
        pytest.skip("native toolchain unavailable")
    return lib


class TestNativeBatcher:
    def test_abi(self, lib):
        assert lib.sg_abi_version() == 1

    def test_assemble_matches_numpy(self, lib):
        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 256, (20, 32, 48, 1), dtype=np.uint8)
        idx = rng.integers(0, 20, 16)
        out = native.assemble_batch(imgs, idx, num_threads=4)
        ref = (imgs[idx].astype(np.float32) - 127.5) / 127.5
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
        assert out.dtype == np.float32

    def test_assemble_single_thread(self, lib):
        rng = np.random.default_rng(1)
        imgs = rng.integers(0, 256, (5, 8, 8), dtype=np.uint8)
        idx = np.array([0, 4, 2])
        out = native.assemble_batch(imgs, idx, num_threads=1)
        ref = (imgs[idx].astype(np.float32) - 127.5) / 127.5
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)

    def test_gather_labels(self, lib):
        labels = np.arange(40, dtype=np.int32).reshape(10, 4)
        idx = np.array([9, 0, 3])
        out = native.gather_labels(labels, idx)
        np.testing.assert_array_equal(out, labels[idx])

    def test_dataset_native_vs_numpy(self, lib, tmp_path):
        from scrabblegan.data import BucketedDataset, make_synthetic_dataset

        read_dir, _, _ = make_synthetic_dataset(str(tmp_path), samples_per_bucket=4,
                                                bucket_size=3)
        ds_nat = BucketedDataset(read_dir, (32, 160, 1), 3, seed=5, use_native=True)
        ds_np = BucketedDataset(read_dir, (32, 160, 1), 3, seed=5, use_native=False)
        imgs_a, labs_a, b_a = ds_nat.sample_batch(6)
        imgs_b, labs_b, b_b = ds_np.sample_batch(6)
        assert b_a == b_b
        np.testing.assert_allclose(imgs_a, imgs_b, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(labs_a, labs_b)

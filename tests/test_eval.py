"""Evaluation subsystem tests: Fréchet distance math, recognizer features,
greedy CTC decode, CER."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scrabblegan.eval import (
    character_error_rate,
    compute_rfid,
    frechet_distance,
    greedy_ctc_decode,
    recognizer_features,
)
from scrabblegan.eval.decode import levenshtein
from scrabblegan.models import Recognizer


class TestFrechet:
    def test_identical_sets_zero(self):
        rng = np.random.default_rng(0)
        a = rng.standard_normal((500, 8))
        assert abs(frechet_distance(a, a.copy())) < 1e-6

    def test_mean_shift(self):
        """For equal covariance, FID ~= |mu_a - mu_b|^2."""
        rng = np.random.default_rng(0)
        a = rng.standard_normal((20000, 4))
        b = rng.standard_normal((20000, 4)) + np.array([2.0, 0, 0, 0])
        fid = frechet_distance(a, b)
        assert 3.5 < fid < 4.6

    def test_monotone_in_separation(self):
        rng = np.random.default_rng(1)
        a = rng.standard_normal((2000, 6))
        near = frechet_distance(a, rng.standard_normal((2000, 6)) + 0.5)
        far = frechet_distance(a, rng.standard_normal((2000, 6)) + 3.0)
        assert far > near


class TestRecognizerFeatures:
    def test_extractor_shape_and_rfid(self):
        rec = Recognizer(num_classes=53)
        x = jnp.zeros((4, 32, 64, 1))
        v = rec.init({"params": jax.random.PRNGKey(0)}, x, True)
        extractor = recognizer_features(rec, v["params"],
                                        v.get("batch_stats", {}))
        rng = np.random.default_rng(0)
        real = rng.uniform(-1, 1, (16, 32, 64, 1)).astype(np.float32)
        feats = extractor(real)
        assert feats.shape == (16, 512)
        fid_same = compute_rfid(real, real.copy(), extractor, batch_size=8)
        assert abs(fid_same) < 1e-4
        fake = np.ones_like(real)  # blank pages vs noise: should be far
        fid_diff = compute_rfid(fake, real, extractor, batch_size=8)
        assert fid_diff > fid_same + 1e-3


class TestDecode:
    def test_collapse_and_blank(self):
        # K=4 (blank=3); frames: a a blank a b b -> "a a b" collapsed to [0,0,1]
        frames = [0, 0, 3, 0, 1, 1]
        logits = np.full((1, 6, 4), -10.0, np.float32)
        for t, f in enumerate(frames):
            logits[0, t, f] = 10.0
        out = greedy_ctc_decode(logits)
        assert out == [[0, 0, 1]]

    def test_length_mask(self):
        logits = np.full((1, 5, 3), -10.0, np.float32)
        for t in range(5):
            logits[0, t, 0] = 10.0
        assert greedy_ctc_decode(logits, np.array([3])) == [[0]]

    def test_cer(self):
        assert levenshtein("kitten", "sitting") == 3
        cer = character_error_rate([[0, 1, 2]], [[0, 1, 3]])
        assert abs(cer - 1 / 3) < 1e-9
        assert character_error_rate([[0]], [[0]]) == 0.0

    def test_decode_returns_int_ids(self):
        """Pins the id convention: decode emits CHAR IDS, so CER references
        must be id sequences too — comparing against char STRINGS silently
        reports CER=1.0 for a perfect model (a real bug the first campaign
        eval shipped with)."""
        logits = np.full((1, 3, 4), -10.0, np.float32)
        logits[0, 0, 2] = 10.0
        logits[0, 1, 3] = 10.0
        logits[0, 2, 2] = 10.0
        (seq,) = greedy_ctc_decode(logits)
        assert seq == [2, 2] and all(isinstance(x, int) for x in seq)
        assert character_error_rate([seq], [[2, 2]]) == 0.0
        assert character_error_rate([seq], [["c", "c"]]) == 1.0


class TestRandomFeatures:
    """Fixed-seed random extractor (eval/fid.py random_features): the
    run-independent second Fréchet axis next to the self-referential rFID."""

    def test_deterministic_and_shape(self):
        from scrabblegan.eval import random_features

        imgs = np.random.default_rng(0).uniform(
            -1, 1, (8, 32, 80, 1)).astype(np.float32)
        a = random_features(seed=0)(imgs)
        b = random_features(seed=0)(imgs)
        assert a.shape == (8, 512)
        np.testing.assert_array_equal(a, b)
        c = random_features(seed=1)(imgs)
        assert not np.allclose(a, c)

    def test_separates_distributions(self):
        from scrabblegan.eval import random_features

        rng = np.random.default_rng(0)
        ex = random_features()
        a = rng.uniform(-1, 1, (64, 32, 80, 1)).astype(np.float32)
        b = rng.uniform(-1, 1, (64, 32, 80, 1)).astype(np.float32)
        shifted = np.clip(a * 0.2 - 0.8, -1, 1)
        near = compute_rfid(a, b, ex, batch_size=32)
        far = compute_rfid(a, shifted, ex, batch_size=32)
        assert far > 5 * near  # same dist ~ sampling floor; shifted >> it

    def test_width_agnostic(self):
        from scrabblegan.eval import random_features

        ex = random_features()
        w80 = ex(np.zeros((2, 32, 80, 1), np.float32))
        w160 = ex(np.zeros((2, 32, 160, 1), np.float32))
        assert w80.shape == w160.shape == (2, 512)


class TestExportGate:
    """eval/gate.py (VERDICT r4 item 5): calibrated rfid_rand gate over
    per-epoch exports, with the same-sample-count real-vs-real floor
    correcting small-batch Fréchet bias."""

    @pytest.fixture(scope="class")
    def word_images(self):
        # synthetic "handwriting": dark strokes on white canvases
        rng = np.random.default_rng(7)
        imgs = np.ones((192, 32, 80, 1), np.float32)
        for i in range(len(imgs)):
            n_strokes = rng.integers(3, 8)
            for _ in range(n_strokes):
                x = rng.integers(0, 76)
                y = rng.integers(0, 28)
                imgs[i, y:y + 4, x:x + 4, 0] = -1.0 + rng.uniform(0, 0.3)
        return imgs

    def test_real_vs_real_is_ok(self, word_images):
        from scrabblegan.eval import score_export

        res = score_export(word_images[:64], word_images[64:192])
        assert res["flag"] == "ok"
        assert res["excess"] < res["threshold"]

    def test_garbage_is_suspect(self, word_images):
        from scrabblegan.eval import score_export

        rng = np.random.default_rng(8)
        garbage = rng.uniform(-1, 1, (64, 32, 80, 1)).astype(np.float32)
        res = score_export(garbage, word_images[:128])
        assert res["flag"] == "suspect"
        assert res["excess"] > res["threshold"]

    def test_annotate_and_latest_good(self, tmp_path):
        from scrabblegan.eval import annotate_export, latest_good_export

        model_dir = str(tmp_path)
        gen_root = tmp_path / "generator"
        for epoch in (1, 2, 3):
            (gen_root / str(epoch)).mkdir(parents=True)
        annotate_export(model_dir, 1, {"flag": "ok"})
        assert latest_good_export(model_dir).endswith("/1")
        annotate_export(model_dir, 2, {"flag": "suspect"})
        # a suspect epoch must NOT advance the symlink
        assert latest_good_export(model_dir).endswith("/1")
        annotate_export(model_dir, 3, {"flag": "ok"})
        assert latest_good_export(model_dir).endswith("/3")
        import json
        import os

        assert os.path.exists(str(gen_root / "quality_2.json"))
        with open(str(gen_root / "quality_2.json")) as f:
            assert json.load(f)["flag"] == "suspect"

    def test_no_gate_no_link(self, tmp_path):
        from scrabblegan.eval import latest_good_export

        assert latest_good_export(str(tmp_path)) is None

"""Data-interface tests: converter format, bucketed loader semantics, style loader
geometry, lexicon encoding (SURVEY.md components 3-6)."""

import os

import numpy as np
import pytest

from scrabblegan.config import CHAR_VECTOR
from scrabblegan.data import (
    BucketedDataset,
    convert_to_gan_format,
    decode_label,
    encode_word,
    load_random_word_list,
    load_style_images,
    make_synthetic_dataset,
)
from scrabblegan.data.iam import parse_iam_words_txt
from scrabblegan.data.images import read_grayscale, write_grayscale
from scrabblegan.data.loaders import sample_fake_labels


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    read_dir, words_file, style_dir = make_synthetic_dataset(
        str(root), samples_per_bucket=6, bucket_size=10)
    return read_dir, words_file, style_dir


class TestEncoding:
    def test_auto_example(self):
        # reference docstring example (data_utils.py:48-49)
        assert encode_word("auto") == [0, 20, 19, 14]
        assert decode_label([0, 20, 19, 14]) == "auto"

    def test_case_sensitivity(self):
        assert encode_word("A") == [26]
        assert encode_word("Z") == [51]


class TestSyntheticFormat:
    def test_bucket_layout(self, synth):
        read_dir, _, _ = synth
        for b in range(1, 11):
            files = os.listdir(os.path.join(read_dir, str(b)))
            pngs = [f for f in files if f.endswith(".png")]
            txts = [f for f in files if f.endswith(".txt")]
            assert len(pngs) == len(txts) == 6
            img = read_grayscale(os.path.join(read_dir, str(b), pngs[0]))
            assert img.shape == (32, 16 * b)  # 16px per char at 32px height


class TestScriptStyle:
    def test_script_dataset_geometry_and_variation(self, tmp_path):
        read_dir, words_file, style_dir = make_synthetic_dataset(
            str(tmp_path), samples_per_bucket=4, bucket_size=3, style="script")
        img = None
        for b in range(1, 4):
            files = sorted(os.listdir(os.path.join(read_dir, str(b))))
            pngs = [f for f in files if f.endswith(".png")]
            assert len(pngs) == 4
            img = read_grayscale(os.path.join(read_dir, str(b), pngs[0]))
            assert img.shape == (32, 16 * b)
        assert img.min() < 80 and img.max() > 200  # real ink on white

    def test_same_word_varies_but_class_is_stable(self):
        from scrabblegan.data.synthetic import _draw_word_script

        rng = np.random.default_rng(0)
        a = _draw_word_script("abc", rng)
        b = _draw_word_script("abc", rng)
        # per-sample slant/jitter: two draws differ materially
        assert np.abs(a - b).mean() > 1.0
        # but determinism holds for a fixed generator state
        c = _draw_word_script("abc", np.random.default_rng(5))
        d = _draw_word_script("abc", np.random.default_rng(5))
        np.testing.assert_array_equal(c, d)

    def test_unknown_style_rejected(self, tmp_path):
        with pytest.raises(ValueError):
            make_synthetic_dataset(str(tmp_path), style="cursive")


class TestLengthSkew:
    """Population-weighted synthetic data (the bucketed-instability skew cell)."""

    def test_bucket_populations(self):
        from scrabblegan.data.synthetic import bucket_populations

        assert bucket_populations(100, 10, None) == (100,) * 10
        pops = bucket_populations(100, 10, "iam")
        # total preserved up to rounding + min-floor adjustments
        assert abs(sum(pops) - 1000) <= 20
        assert pops[2] == max(pops)  # len-3 peaks (running-English skew)
        assert min(pops) >= 8  # no length disappears from the pool
        with pytest.raises(ValueError):
            bucket_populations(100, 10, "zipf")
        with pytest.raises(ValueError):
            bucket_populations(100, 10, [0.5])  # too few weights

    def test_skewed_dataset_drives_loader_weights(self, tmp_path):
        from scrabblegan.data.synthetic import bucket_populations

        read_dir, _, _ = make_synthetic_dataset(
            str(tmp_path), samples_per_bucket=20, bucket_size=10,
            length_weights="iam")
        pops = bucket_populations(20, 10, "iam")
        ds = BucketedDataset(read_dir, (32, 160, 1), 10)
        for b in range(1, 11):
            assert len(ds.labels[b]) == pops[b - 1]
        # loader's population-weighted bucket sampling reproduces the skew
        np.testing.assert_allclose(
            ds.bucket_weights, np.asarray(pops) / sum(pops), atol=1e-9)


class TestBucketedDataset:
    def test_shapes_and_range(self, synth):
        read_dir, _, _ = synth
        ds = BucketedDataset(read_dir, (32, 160, 1), 10)
        assert ds.num_samples == 60
        imgs, labels, bucket = ds.sample_batch(4)
        assert imgs.shape == (4, 32, 16 * bucket, 1)
        assert labels.shape == (4, bucket)
        assert imgs.min() >= -1.0 and imgs.max() <= 1.0
        assert labels.min() >= 0 and labels.max() < 52

    def test_bucket_weights_follow_population(self, synth):
        read_dir, _, _ = synth
        ds = BucketedDataset(read_dir, (32, 160, 1), 10)
        np.testing.assert_allclose(ds.bucket_weights, [0.1] * 10)
        assert abs(sum(ds.bucket_weights) - 1.0) < 1e-9

    def test_generator_protocol(self, synth):
        read_dir, _, _ = synth
        ds = BucketedDataset(read_dir, (32, 160, 1), 10)
        gen = ds.batches(3)
        imgs, labels = next(gen)
        assert imgs.shape[0] == 3 and labels.shape[0] == 3

    def test_multi_dataset_merge(self, synth, tmp_path):
        """dinterface multi-dataset intent: several converted datasets merge
        into one sampling pool (IAM + RIMES slot)."""
        read_dir, _, _ = synth
        read_dir2, _, _ = make_synthetic_dataset(str(tmp_path / "d2"),
                                                 samples_per_bucket=2,
                                                 bucket_size=10, seed=9)
        ds = BucketedDataset([read_dir, read_dir2], (32, 160, 1), 10)
        assert ds.num_samples == 60 + 20
        imgs, labels, bucket = ds.sample_batch(4)
        assert imgs.shape == (4, 32, 16 * bucket, 1)


class TestStyleLoader:
    def test_geometry_and_split(self, synth):
        _, _, style_dir = synth
        train, validate = load_style_images(style_dir, (32, 160, 1))
        assert len(train) + len(validate) == 12
        assert len(validate) == 1  # 95/5 split of 12
        for img in train + validate:
            assert img.shape == (32, 160)
            assert img.min() >= -1.0 and img.max() <= 1.0

    def test_white_padding(self, tmp_path):
        # a 2-char-wide image must be white-padded on the right to 160
        img = np.zeros((64, 40), np.float32)  # black, tall
        write_grayscale(str(tmp_path / "s.png"), img)
        train, _ = load_style_images(str(tmp_path), (32, 160, 1), train_fraction=1.0)
        out = train[0]
        assert out.shape == (32, 160)
        np.testing.assert_allclose(out[:, -10:], 1.0)  # white padding
        np.testing.assert_allclose(out[:, :10], -1.0)  # black content

    def test_validate_aspect_rule_wide_image(self, tmp_path):
        """VERDICT r4 item 8: the validate split uses rate = min(h/ht, w/wt)
        (reference data_utils.py:173-179) — a WIDE image is width-fit to
        exactly 160 with height int(ht*rate) < 32, NOT height-fit-then-
        cropped. Pin both splits' algebra on the same wide source."""
        # 64x1280: h/ht = 0.5, w/wt = 0.125 -> validate rate 0.125,
        # resized to (8, 160); train rate 0.5 -> (32, 640) right-cropped.
        img = np.zeros((64, 1280), np.float32)  # all black, very wide
        write_grayscale(str(tmp_path / "wide.png"), img)

        train, _ = load_style_images(str(tmp_path), (32, 160, 1),
                                     train_fraction=1.0)
        t = train[0]
        assert t.shape == (32, 160)
        np.testing.assert_allclose(t, -1.0)  # height-fit: crop is still black

        _, validate = load_style_images(str(tmp_path), (32, 160, 1),
                                        train_fraction=0.0)
        v = validate[0]
        assert v.shape == (32, 160)
        # width-fit: rows 0..7 are the black content, rows 8.. white padding
        np.testing.assert_allclose(v[:8], -1.0)
        np.testing.assert_allclose(v[8:], 1.0)

    def test_validate_rule_matches_train_for_narrow(self, tmp_path):
        """Narrow images (h/ht <= w/wt) take the SAME height-fit branch in
        both splits (only the interpolation differs: area vs cubic)."""
        rng = np.random.default_rng(3)
        img = rng.uniform(0, 255, (64, 80)).astype(np.float32)
        write_grayscale(str(tmp_path / "n.png"), img)
        train, _ = load_style_images(str(tmp_path), (32, 160, 1),
                                     train_fraction=1.0)
        _, validate = load_style_images(str(tmp_path), (32, 160, 1),
                                        train_fraction=0.0)
        assert train[0].shape == validate[0].shape == (32, 160)
        # identical white padding region (content width 40 both ways)
        np.testing.assert_allclose(train[0][:, 40:], 1.0)
        np.testing.assert_allclose(validate[0][:, 40:], 1.0)


class TestLexicon:
    def test_bucketing_and_filtering(self, tmp_path):
        path = tmp_path / "words.txt"
        path.write_text("a\nab\nabc\ntoolongwordhere\nbad-char\nAbC\n")
        buckets = load_random_word_list(str(path), 10)
        assert [encode_word("a")] == buckets[0]
        assert len(buckets[1]) == 1
        assert sorted(map(tuple, buckets[2])) == sorted(
            [tuple(encode_word("abc")), tuple(encode_word("AbC"))])
        assert all(len(b) == 0 for b in buckets[3:])

    def test_sample_fake_labels(self, synth):
        _, words_file, _ = synth
        buckets = load_random_word_list(words_file, 10)
        rng = np.random.default_rng(0)
        labels = sample_fake_labels(rng, buckets, 8, 4)
        assert labels.shape == (8, 4)
        assert labels.dtype == np.int32


class TestConverter:
    def test_iam_words_txt_parsing(self, tmp_path):
        txt = tmp_path / "words.txt"
        txt.write_text(
            "# comment line\n"
            "a01-000u-00-00 ok 154 408 768 27 51 AT A\n"
            "a01-000u-00-01 err 154 408 768 27 51 AT move\n"
        )
        tr = parse_iam_words_txt(str(txt))
        assert tr["a01-000u-00-00.png"] == "A"
        assert tr["a01-000u-00-01.png"] == "-1"

    def test_convert_resizes_and_buckets(self, tmp_path):
        raw = tmp_path / "img" / "a01"
        raw.mkdir(parents=True)
        write_grayscale(str(raw / "w1.png"), np.full((50, 90), 128.0))
        write_grayscale(str(raw / "w2.png"), np.full((40, 200), 128.0))
        out = tmp_path / "reading"
        transcriptions = {"w1.png": "cat", "w2.png": "No7"}  # second filtered (digit)
        n, lengths = convert_to_gan_format(
            str(tmp_path / "img"), str(out), (32, 160, 1), 10, transcriptions,
            verbose=False)
        assert n == 1
        assert lengths[3] == 1
        img = read_grayscale(str(out / "3" / "w1.png"))
        assert img.shape == (32, 48)
        assert (out / "3" / "w1.txt").read_text() == "cat"


class TestRimesConverter:
    def test_groundtruth_parsing(self, tmp_path):
        from scrabblegan.data.iam import parse_rimes_groundtruth

        gt = tmp_path / "ground_truth.txt"
        gt.write_text(
            "images/lot_1/word-001.png bonjour\n"
            "images/lot_2/word-002.png le\n"
            "malformed_line_without_word\n"
        )
        tr = parse_rimes_groundtruth(str(gt))
        assert tr["word-001.png"] == "bonjour"
        assert tr["word-002.png"] == "le"
        assert len(tr) == 2

    def test_init_reading_rimes_end_to_end(self, tmp_path):
        """Fabricated mini-RIMES tree -> bucketed GAN-Reading output; the
        second concrete dataset handler the dinterface layer was designed for
        (reference README:58; the reference never shipped it)."""
        from scrabblegan.data.iam import DATASET_HANDLERS

        raw = tmp_path / "rimes"
        (raw / "images").mkdir(parents=True)
        write_grayscale(str(raw / "images" / "r1.png"), np.full((60, 120), 90.0))
        write_grayscale(str(raw / "images" / "r2.png"), np.full((30, 80), 90.0))
        (raw / "ground_truth.txt").write_text(
            "images/r1.png merci\nimages/r2.png No7\n")  # second filtered
        out = tmp_path / "reading"
        n, lengths = DATASET_HANDLERS["rimes"](
            str(raw), str(out), (32, 160, 1), 10)
        assert n == 1
        assert lengths[5] == 1
        img = read_grayscale(str(out / "5" / "r1.png"))
        assert img.shape == (32, 80)  # 16px/char * 5 chars
        assert (out / "5" / "r1.txt").read_text() == "merci"

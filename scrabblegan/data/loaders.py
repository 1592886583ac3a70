"""Host-side in-memory loaders feeding the device: bucketed train data, style
images, and the random-word lexicon.

Capability parity with the loader half of data_utils.py (SURVEY.md components
4/5/6):
- BucketedDataset (data_utils.py:14-84): reads all buckets into RAM, computes
  per-bucket sampling weights proportional to bucket population, and serves
  batches sampled with replacement from a weight-drawn bucket, normalized to
  [-1, 1], shaped (B, 32, 16*bucket, 1).
- load_style_images (data_utils.py:87-195): loads a folder of personal handwriting
  images, 95/5 train/validate split, height-resize to 32 preserving aspect, then
  right-crop or white-pad (255) to exactly 32x160, normalized to [-1, 1].
- load_random_word_list (data_utils.py:550-574): parses a lexicon file into
  per-length buckets of encoded words.

Design differences: batches are materialized as numpy with STATIC per-bucket
shapes and NamedSharding device_put is handled by the caller; sampling uses a
seeded numpy Generator for reproducibility (the reference uses the global
random/np.random state).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from scrabblegan.config import CHAR_VECTOR
from scrabblegan.data.images import read_grayscale, resize


def encode_word(word: str, char_vector: str = CHAR_VECTOR) -> List[int]:
    """'auto' -> [0, 20, 19, 14] (char_vector.index encoding, data_utils.py:49)."""
    return [char_vector.index(ch) for ch in word]


def decode_label(label: Sequence[int], char_vector: str = CHAR_VECTOR) -> str:
    return "".join(char_vector[i] for i in label)


class BucketedDataset:
    """In-RAM bucketed dataset with population-weighted bucket sampling.

    Images are held as uint8 (half the RAM of the reference's float lists); the
    gather + normalize of batch assembly runs through the native C++ assembler
    (scrabblegan.data.native) when the library is available, with a numpy
    fallback of identical numerics."""

    def __init__(self, reading_dir, input_dim: Tuple[int, int, int],
                 bucket_size: int, char_vector: str = CHAR_VECTOR, seed: int = 0,
                 use_native: bool = True):
        """reading_dir: one bucketed dataset dir, or a list of them — multiple
        datasets (e.g. IAM + RIMES, both converted by data.iam handlers into the
        common GAN-Reading format) merge into one sampling pool, realizing the
        dinterface multi-dataset intent (reference README:58)."""
        self.h, self.w_max, self.c = input_dim
        self.bucket_size = bucket_size
        self.char_vector = char_vector
        self.use_native = use_native
        self._rng = np.random.default_rng(seed)
        reading_dirs = ([reading_dir] if isinstance(reading_dir, (str, os.PathLike))
                        else list(reading_dir))

        self.images: Dict[int, np.ndarray] = {}
        self.labels: Dict[int, np.ndarray] = {}
        total = 0
        for b in range(1, bucket_size + 1):
            imgs, labs = [], []
            for rd in reading_dirs:
                bucket_dir = os.path.join(rd, str(b))
                if not os.path.isdir(bucket_dir):
                    continue
                for fn in sorted(os.listdir(bucket_dir)):
                    if not fn.endswith(".txt"):
                        continue
                    stem = os.path.splitext(fn)[0]
                    with open(os.path.join(bucket_dir, fn), encoding="utf8") as f:
                        word = f.readline().strip()
                    img = read_grayscale(os.path.join(bucket_dir, stem + ".png"))
                    if img is None or len(word) != b:
                        continue
                    imgs.append(img)
                    labs.append(encode_word(word, char_vector))
            width = (self.h // 2) * b
            if imgs:
                self.images[b] = np.ascontiguousarray(
                    np.stack(imgs).reshape(-1, self.h, width, self.c), np.uint8)
                self.labels[b] = np.asarray(labs, np.int32)
            else:
                self.images[b] = np.zeros((0, self.h, width, self.c), np.uint8)
                self.labels[b] = np.zeros((0, b), np.int32)
            total += len(imgs)

        self.num_samples = total
        if total == 0:
            raise ValueError(f"no samples found under {reading_dir}")
        self.bucket_weights = np.array(
            [len(self.labels[b]) / total for b in range(1, bucket_size + 1)])
        self.nonempty = [b for b in range(1, bucket_size + 1) if len(self.labels[b])]

    def sample_bucket(self) -> int:
        """Bucket index (1-based) drawn by population weight (data_utils.py:64)."""
        return int(self._rng.choice(self.bucket_size, p=self.bucket_weights)) + 1

    def sample_batch(self, batch_size: int, bucket: int | None = None,
                     raw: bool = False) -> Tuple[np.ndarray, np.ndarray, int]:
        """Returns (images (B, 32, 16*bucket, 1) in [-1,1], labels (B, bucket), bucket).

        Samples WITH replacement inside the bucket (data_utils.py:70-74).
        raw=True skips the host normalize and returns the gathered uint8 bytes
        (the 'uint8' wire format; the jitted step normalizes on-device with the
        identical formula)."""
        if bucket is None:
            bucket = self.sample_bucket()
        n = len(self.labels[bucket])
        idx = self._rng.integers(0, n, size=batch_size)
        if raw:
            return (self.images[bucket][idx].copy(),
                    self.labels[bucket][idx].copy(), bucket)
        if self.use_native:
            from scrabblegan.data import native

            imgs = native.assemble_batch(self.images[bucket], idx)
            labels = native.gather_labels(self.labels[bucket], idx)
        else:
            imgs = (self.images[bucket][idx].astype(np.float32) - 127.5) / 127.5
            labels = self.labels[bucket][idx].copy()
        return imgs, labels, bucket

    def batches(self, batch_size: int):
        """Infinite generator mirroring load_prepare_data (data_utils.py:62-84)."""
        while True:
            imgs, labs, _ = self.sample_batch(batch_size)
            yield imgs, labs


def _fit_canvas(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Right-crop or white-pad to exactly (h, w) (data_utils.py:146-155).

    Width: crop from the right or pad with white (255). Height: the reference's
    train split always resizes to exactly h, but its VALIDATE split width-fits
    wide images leaving height int(ht*rate) < h with NO re-fit (and no assert
    in that loop, data_utils.py:179-189 — downstream np.stack of the fixed
    seed would fail on a ragged list). The static-shape pipeline here
    bottom-pads the height with white instead, keeping the resize algebra
    reference-exact while every output stays (h, w)."""
    height, width = img.shape
    if width > w:
        img = img[:, :w]
    if img.shape != (h, w):
        out = np.ones((h, w), np.float32) * 255.0
        out[:height, : img.shape[1]] = img
        return out
    return img


def load_style_images(style_dir: str, input_dim: Tuple[int, int, int],
                      train_fraction: float = 0.95, seed: int = 0
                      ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Load the target-style handwriting folder -> (train, validate) lists of
    (32, 160) float arrays in [-1, 1].

    Split aspect rules match the reference exactly (VERDICT r4 item 8):
    - train (data_utils.py:142-145): height-fit — rate = h/ht, INTER_AREA,
      then right-crop / white-pad the width.
    - validate (data_utils.py:173-179): rate = min(h/ht, w/wt), INTER_CUBIC —
      a wide image (w/wt < h/ht) is WIDTH-fit to exactly w with height
      int(ht*rate) <= h (then white-padded to the static canvas, see
      _fit_canvas)."""
    h, w, _c = input_dim
    files = sorted(os.listdir(style_dir))
    rng = np.random.default_rng(seed)
    rng.shuffle(files)
    split = int(len(files) * train_fraction)

    def _load(fn: str, quality: str, validate_rule: bool) -> np.ndarray | None:
        img = read_grayscale(os.path.join(style_dir, fn))
        if img is None:
            return None
        ht, wt = img.shape
        if validate_rule and w / float(wt) < h / float(ht):
            # wide image under the validate rule: width-fit, height shrinks
            rate = w / float(wt)
            new_w, new_h = w, max(1, int(ht * rate))
        else:
            rate = h / float(ht)
            new_w, new_h = max(1, int(wt * rate)), h
        resized = resize(img.astype(np.float32), new_w, new_h, quality=quality)
        final = _fit_canvas(resized.astype(np.float32), h, w)
        assert final.shape == (h, w)
        return (final - 127.5) / 127.5

    train = [x for fn in files[:split]
             if (x := _load(fn, "area", False)) is not None]
    validate = [x for fn in files[split:]
                if (x := _load(fn, "cubic", True)) is not None]
    return train, validate


def load_random_word_list(words_file: str, bucket_size: int,
                          char_vector: str = CHAR_VECTOR) -> List[List[List[int]]]:
    """Lexicon -> per-length buckets of encoded words (data_utils.py:550-574).

    random_words[k] holds words of length k+1. Words longer than bucket_size or
    containing characters outside char_vector are dropped."""
    buckets: List[List[List[int]]] = [[] for _ in range(bucket_size)]
    with open(words_file, encoding="utf8") as f:
        for line in f:
            word = line.strip()
            if not word or len(word) > bucket_size:
                continue
            if not all(ch in char_vector for ch in word):
                continue
            buckets[len(word) - 1].append(encode_word(word, char_vector))
    return buckets


def sample_fake_labels(rng: np.random.Generator, random_words, batch_size: int,
                       bucket: int) -> np.ndarray:
    """Draw batch_size encoded words of length `bucket` (data_utils.py:385-387)."""
    pool = random_words[bucket - 1]
    if not pool:
        return rng.integers(0, 52, size=(batch_size, bucket)).astype(np.int32)
    idx = rng.integers(0, len(pool), size=batch_size)
    return np.asarray([pool[i] for i in idx], np.int32)

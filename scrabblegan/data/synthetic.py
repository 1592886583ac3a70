"""Synthetic on-disk dataset fixture in the bucketed GAN-Reading format.

Stands in for IAM in tests and benchmarks (SURVEY.md §4: "a tiny synthetic on-disk
dataset fixture standing in for IAM — the bucketed png+txt format is trivial to
fabricate"). Images are procedurally drawn per-character stripe patterns so the
recognizer has learnable (if trivial) structure.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from scrabblegan.config import CHAR_VECTOR
from scrabblegan.data.images import write_grayscale

# Approximate word-length distribution of running English text (lengths 1..10),
# used as the stand-in for IAM's natural length skew (IAM is running text; the
# reference's converter prints the real histogram, iam_handwriting_db.py:93 —
# not reproducible here with no dataset on disk, so this is an explicit
# approximation: short words dominate, len-3 peaks, a long tail).
IAM_LENGTH_WEIGHTS = (0.03, 0.17, 0.23, 0.15, 0.11, 0.08, 0.07, 0.06,
                      0.055, 0.045)

_WORDS = (
    "a an the and of to in is it he she we they word hand write pen ink page "
    "letter script style glyph stroke curve line dot bar loop tail stem bowl "
    "serif quick brown fox jumps over lazy dog alphabet character".split()
)


def _draw_word(word: str, h: int = 32) -> np.ndarray:
    """Deterministic per-character texture: each char renders a 16px-wide stripe
    pattern keyed by its index, on a white background."""
    w = (h // 2) * len(word)
    img = np.full((h, w), 255.0, np.float32)
    for i, ch in enumerate(word):
        code = CHAR_VECTOR.index(ch) if ch in CHAR_VECTOR else 0
        x0 = i * (h // 2)
        ys = np.arange(h)[:, None]
        xs = np.arange(h // 2)[None, :]
        pattern = 127.5 + 127.5 * np.sin(
            0.35 * (code + 1) * xs + 0.2 * (code % 7 + 1) * ys)
        img[:, x0:x0 + h // 2] = np.minimum(img[:, x0:x0 + h // 2], pattern)
    return img


def _glyph_control_points(code: int, n_strokes: int = 3):
    """Deterministic per-character stroke skeleton: `n_strokes` quadratic
    Beziers in a unit cell, keyed by the char code. Class identity lives
    here; per-sample variation is added on top in `_draw_word_script`."""
    g = np.random.default_rng(7919 * (code + 1) + 13)
    pts = g.uniform(0.12, 0.88, size=(n_strokes, 3, 2))
    # connect strokes so glyphs read as one cursive mark, not scattered arcs
    for s in range(1, n_strokes):
        pts[s, 0] = pts[s - 1, 2]
    return pts


def _draw_word_script(word: str, rng: np.random.Generator,
                      h: int = 32) -> np.ndarray:
    """Handwriting-like rendering: per-char Bezier strokes with PER-SAMPLE
    random slant, stroke thickness, control-point jitter, and baseline shift —
    a nontrivial intra-class distribution for the GAN to learn (the stripes
    style is a delta function per class; this one is not)."""
    cw = h // 2
    w = cw * len(word)
    img = np.full((h, w), 255.0, np.float32)
    slant = rng.uniform(-0.30, 0.30)             # shear, shared across the word
    thick = rng.uniform(0.7, 1.5)                # stroke sigma (pixels)
    base = rng.uniform(-2.0, 2.0)                # baseline shift (pixels)
    yy = np.arange(h, dtype=np.float32)[:, None]
    xx = np.arange(cw, dtype=np.float32)[None, :]
    t = np.linspace(0.0, 1.0, 48, dtype=np.float32)[:, None]
    for i, ch in enumerate(word):
        code = CHAR_VECTOR.index(ch) if ch in CHAR_VECTOR else 0
        cps = _glyph_control_points(code)
        cps = cps + rng.normal(0, 0.045, size=cps.shape)   # per-sample jitter
        ink = np.zeros((h, cw), np.float32)
        for p0, p1, p2 in cps:
            b = ((1 - t) ** 2 * p0 + 2 * t * (1 - t) * p1 + t ** 2 * p2)
            px = b[:, 0] * (cw - 1)                        # (T,)
            py = b[:, 1] * (h - 1) + base
            px = px + slant * (py - h / 2)                 # shear about center
            d2 = ((yy[..., None] - py) ** 2 +
                  (xx[..., None] - px) ** 2)               # (h, cw, T)
            ink = np.maximum(ink, np.exp(-d2 / (2 * thick ** 2)).max(-1))
        x0 = i * cw
        img[:, x0:x0 + cw] = np.minimum(img[:, x0:x0 + cw],
                                        255.0 * (1.0 - ink))
    return img


def bucket_populations(samples_per_bucket: int, bucket_size: int,
                       length_weights: Union[None, str, Sequence[float]],
                       min_per_bucket: int = 8) -> Tuple[int, ...]:
    """Per-bucket sample counts. None = uniform (samples_per_bucket each);
    'iam' = IAM_LENGTH_WEIGHTS; a sequence = explicit weights. Weighted modes
    keep the TOTAL at samples_per_bucket * bucket_size and floor each bucket
    at min_per_bucket so no length disappears from the sampling pool."""
    if length_weights is None:
        return (samples_per_bucket,) * bucket_size
    if isinstance(length_weights, str):
        if length_weights != "iam":
            raise ValueError(f"unknown length_weights {length_weights!r}")
        length_weights = IAM_LENGTH_WEIGHTS
    w = np.asarray(length_weights, np.float64)[:bucket_size]
    if len(w) < bucket_size or (w < 0).any() or w.sum() <= 0:
        raise ValueError("length_weights needs a nonnegative weight per bucket")
    total = samples_per_bucket * bucket_size
    counts = np.maximum(np.round(total * w / w.sum()).astype(int),
                        min(min_per_bucket, samples_per_bucket))
    return tuple(int(c) for c in counts)


def make_synthetic_dataset(root: str, samples_per_bucket: int = 8,
                           bucket_size: int = 10, h: int = 32,
                           seed: int = 0,
                           style: str = "stripes",
                           length_weights: Union[None, str, Sequence[float]]
                           = None) -> Tuple[str, str, str]:
    """Create <root>/words-Reading/{1..bucket_size}/ + a lexicon + style images.

    style: "stripes" (deterministic textures; fast, used by tests/bench) or
    "script" (Bezier pseudo-handwriting with per-sample slant/thickness/jitter;
    used by the quality campaign — gives the GAN a real distribution to model).
    length_weights: None = uniform bucket populations; 'iam' or a weight
    sequence skews them (bucket_populations) — BucketedDataset's
    population-weighted bucket sampling then reproduces the skew at train time.
    Returns (read_dir, words_file, style_dir)."""
    rng = np.random.default_rng(seed)
    if style not in ("stripes", "script"):
        raise ValueError(f"unknown synthetic style {style!r}")
    script = style == "script"
    read_dir = os.path.join(root, "words-Reading")
    style_dir = os.path.join(root, "style_imgs")
    words_file = os.path.join(root, "random_words.txt")
    os.makedirs(style_dir, exist_ok=True)

    populations = bucket_populations(samples_per_bucket, bucket_size,
                                     length_weights)
    chars = list(CHAR_VECTOR)
    lexicon = set(_WORDS)
    for b in range(1, bucket_size + 1):
        bucket_dir = os.path.join(read_dir, str(b))
        os.makedirs(bucket_dir, exist_ok=True)
        for s in range(populations[b - 1]):
            word = "".join(rng.choice(chars, size=b))
            lexicon.add(word)
            img = (_draw_word_script(word, rng, h) if script
                   else _draw_word(word, h))
            noise = rng.normal(0, 4 if script else 8, img.shape)
            write_grayscale(os.path.join(bucket_dir, f"s{b}_{s}.png"), img + noise)
            with open(os.path.join(bucket_dir, f"s{b}_{s}.txt"), "w") as f:
                f.write(word)

    with open(words_file, "w") as f:
        f.write("\n".join(sorted(lexicon)))

    for s in range(12):
        word = "".join(rng.choice(chars, size=int(rng.integers(3, 10))))
        img = (_draw_word_script(word, rng, h) if script
               else _draw_word(word, h))
        write_grayscale(os.path.join(style_dir, f"style_{s}.png"), img)
    return read_dir, words_file, style_dir

"""Quality evaluation: Fréchet distance between generated and real word images.

BASELINE.json's quality criterion is "FID parity with the TF2 reference on IAM".
Classic FID requires InceptionV3 weights, which cannot be downloaded in a
zero-egress environment; this module implements the full Fréchet machinery with a
PLUGGABLE feature extractor and ships a built-in one — the trained recognizer's
conv trunk (pooled 512-d features), i.e. "rFID". Any callable
`images (N,H,W,C) in [-1,1] -> features (N,D)` (e.g. a real Inception embedding
where weights are available) can be passed instead.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    """FID between two feature sets (N_a, D), (N_b, D):
    |mu_a - mu_b|^2 + tr(Ca + Cb - 2 sqrtm(Ca Cb))."""
    import scipy.linalg

    feats_a = np.asarray(feats_a, np.float64)
    feats_b = np.asarray(feats_b, np.float64)
    mu_a, mu_b = feats_a.mean(0), feats_b.mean(0)
    cov_a = np.cov(feats_a, rowvar=False)
    cov_b = np.cov(feats_b, rowvar=False)

    diff = mu_a - mu_b
    # no `disp` argument: newer scipy releases removed it
    covmean = scipy.linalg.sqrtm(cov_a @ cov_b)
    if not np.isfinite(covmean).all():
        offset = np.eye(cov_a.shape[0]) * eps
        covmean = scipy.linalg.sqrtm((cov_a + offset) @ (cov_b + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(cov_a) + np.trace(cov_b)
                 - 2.0 * np.trace(covmean))


def recognizer_features(recognizer, r_params, r_stats) -> Callable:
    """Feature extractor from a (trained) Recognizer: pooled 512-d conv features."""
    import jax

    @jax.jit
    def extract(imgs):
        return recognizer.apply({"params": r_params, "batch_stats": r_stats},
                                imgs, train=False, return_features=True)

    def extractor(images: np.ndarray) -> np.ndarray:
        return np.asarray(extract(images))

    return extractor


def compute_rfid(gen_images: np.ndarray, real_images: np.ndarray,
                 extractor: Callable, batch_size: Optional[int] = None) -> float:
    """Fréchet distance between generated and real images under `extractor`.

    Images must share one shape (use a common bucket or padded canvases)."""
    def feats(images):
        if batch_size is None:
            return extractor(images)
        out = [extractor(images[i:i + batch_size])
               for i in range(0, len(images), batch_size)]
        return np.concatenate(out, 0)

    return frechet_distance(feats(gen_images), feats(real_images))


def random_features(seed: int = 0, widths=(64, 128, 256, 512)) -> Callable:
    """Feature extractor from a FIXED-SEED random (untrained) conv net.

    A second, independent Fréchet axis next to `recognizer_features`: the
    recognizer extractor is trained by the very run being scored (rFID is
    self-referential), while this one is a deterministic function of `seed`
    only — identical across runs, arms, and rounds, with no training signal
    from either distribution. Random untrained embeddings are a known usable
    FID backbone (features = hierarchies of random projections; Fréchet
    distance over them still separates distributions), and agreement between
    the two extractors is evidence a quality trend is not an artifact of the
    recognizer's own features.

    Architecture: 3x3 stride-2 He-initialized convs (`widths` deep) + ReLU,
    global average pool -> (N, widths[-1]). Width-pooling makes it length-
    agnostic like the recognizer trunk. JAX's threefry RNG makes the weights
    backend- and shape-independent for a given seed.
    """
    import jax
    import jax.numpy as jnp

    keys = jax.random.split(jax.random.PRNGKey(seed), len(widths))
    kernels = []
    cin = 1
    for k, w in zip(keys, widths):
        fan_in = 9 * cin
        kernels.append(jax.random.normal(k, (3, 3, cin, w), jnp.float32)
                       * (2.0 / fan_in) ** 0.5)
        cin = w

    @jax.jit
    def extract(imgs):
        x = jnp.asarray(imgs, jnp.float32)
        if x.ndim == 3:
            x = x[..., None]
        for kern in kernels:
            x = jax.lax.conv_general_dilated(
                x, kern, window_strides=(2, 2), padding="SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"))
            x = jnp.maximum(x, 0.0)
        return x.mean(axis=(1, 2))

    def extractor(images: np.ndarray) -> np.ndarray:
        return np.asarray(extract(images))

    return extractor

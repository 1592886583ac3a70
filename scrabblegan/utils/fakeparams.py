"""Fast fake parameter trees for compile checks and throughput benchmarks.

Real initialization runs orthogonal QRs over ~134M params (about a minute on
CPU). Compile checks and FLOP benchmarks don't
need trained-quality values — but they DO need numerically sane ones: spectral
-norm sigma divisors must be ~1 and BN running variances positive, or the
forward overflows to NaN. This filler is path-aware:

  */sigma      -> 1.0        (SN divisor: no amplification)
  * var        -> 1.0        (BN running variance)
  * mean       -> 0.0        (BN running mean)
  everything else float -> N(0, 0.02)
  integer leaves -> 0
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def fake_variables(shapes, seed: int = 0):
    """shapes: a pytree of ShapeDtypeStructs (from jax.eval_shape)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        key = jax.tree_util.keystr(path).lower()
        if np.issubdtype(s.dtype, np.integer):
            return jnp.zeros(s.shape, s.dtype)
        if "sigma" in key or key.endswith("var']"):
            return jnp.ones(s.shape, s.dtype)
        if key.endswith("mean']"):
            return jnp.zeros(s.shape, s.dtype)
        return jnp.asarray(
            rng.standard_normal(s.shape).astype(np.float32) * 0.02
        ).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)

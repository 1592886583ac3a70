"""Lean Adam: the optimizer update is a device-memory bandwidth cost, and this
module shrinks the bytes.

Capability parity: the update math is Adam exactly as the reference configures
it (/root/reference/src/main.py:25-35, scrabble_gan.gin:5-14 — lr 2e-4,
beta_1=0.0, beta_2=0.999); what changes is the memory layout of the state.

Why: the four networks total 134M parameters; a stock f32 Adam update moves
28 B/param (read grad, m, v, p; write m, v, p) = 3.75 GB/step — the update is
a bandwidth-floor cost, not a compute or op-count one (150 leaves total, and
XLA already fuses each leaf's elementwise chain). Two levers:

1. **First-moment elision at beta_1 == 0** (the reference's own default!):
   m = beta_1*m + (1-beta_1)*g degenerates to m = g, so the m buffer never
   needs to exist — its 8 B/param (read + write) vanish and the update
   u = g / (sqrt(v_hat) + eps) is BITWISE the same math.
2. **Low-precision second moment** (`moment_dtype='bfloat16'`): v is a smooth
   positive EMA of g^2; storing it in bf16 costs ~0.4% relative error on v
   (~0.2% on the per-parameter step size) and halves v's 8 B/param.

Together: 28 -> 16 B/param, a ~2.3 ms cut of the measured 6.1 ms tail.

State layout: `ScaleByLeanAdamState(count, mu, nu)` — `mu` is None when
beta_1 == 0 (None is an empty pytree, so checkpoints simply omit it).
Checkpoint-coupled like `parallel.shape_mode`: the workdir's `config.json`
(written by the Trainer) records `optimizer.adam_impl`/`moment_dtype`, and
infer/evaluate/resume auto-load it.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax


class ScaleByLeanAdamState(NamedTuple):
    count: jnp.ndarray
    mu: Any  # None when beta_1 == 0 (elided), else a params-shaped tree
    nu: Any  # params-shaped tree in moment_dtype


def scale_by_lean_adam(b1: float, b2: float, eps: float = 1e-8,
                       moment_dtype: Optional[str] = None
                       ) -> optax.GradientTransformation:
    """Adam's scale transform with (a) the m buffer elided when b1 == 0 and
    (b) moments *stored* in `moment_dtype` (math stays in the grad dtype)."""
    md = None if moment_dtype in (None, "float32") else jnp.dtype(moment_dtype)
    elide_mu = b1 == 0.0

    def _store(x, like):
        return x.astype(md) if md is not None else x.astype(like.dtype)

    def init_fn(params):
        mu = (None if elide_mu else
              jax.tree.map(lambda p: jnp.zeros(p.shape, md or p.dtype), params))
        nu = jax.tree.map(lambda p: jnp.zeros(p.shape, md or p.dtype), params)
        return ScaleByLeanAdamState(count=jnp.zeros((), jnp.int32), mu=mu, nu=nu)

    def update_fn(updates, state, params=None):
        del params
        count = optax.safe_increment(state.count)
        # EMA math in the gradient dtype; only the carried state is low-prec
        nu = jax.tree.map(
            lambda g, v: b2 * v.astype(g.dtype) + (1.0 - b2) * jnp.square(g),
            updates, state.nu)
        bc2 = 1.0 - jnp.asarray(b2, jnp.float32) ** count.astype(jnp.float32)
        if elide_mu:
            # b1 == 0: m == g and the bias correction (1 - b1^t) == 1
            mu_hat = updates
            new_mu = None
        else:
            mu = jax.tree.map(
                lambda g, m: b1 * m.astype(g.dtype) + (1.0 - b1) * g,
                updates, state.mu)
            bc1 = (1.0 -
                   jnp.asarray(b1, jnp.float32) ** count.astype(jnp.float32))
            mu_hat = jax.tree.map(lambda m: m / bc1.astype(m.dtype), mu)
            new_mu = jax.tree.map(_store, mu, updates)
        upd = jax.tree.map(
            lambda m, v: m / (jnp.sqrt(v / bc2.astype(v.dtype)) + eps),
            mu_hat, nu)
        new_nu = jax.tree.map(_store, nu, updates)
        return upd, ScaleByLeanAdamState(count=count, mu=new_mu, nu=new_nu)

    return optax.GradientTransformation(init_fn, update_fn)


def lean_adam(learning_rate, b1: float, b2: float, eps: float = 1e-8,
              moment_dtype: Optional[str] = None
              ) -> optax.GradientTransformation:
    """Drop-in for optax.adam(learning_rate, b1, b2) with the lean state."""
    return optax.chain(
        scale_by_lean_adam(b1, b2, eps=eps, moment_dtype=moment_dtype),
        optax.scale_by_learning_rate(learning_rate),
    )

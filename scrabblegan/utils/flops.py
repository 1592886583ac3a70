"""Analytic matmul/conv FLOP accounting (VERDICT r1 item 4: "img/s without an
analytic-FLOPs denominator can't answer 'is this actually fast'").

Counts the exact matmul/conv FLOPs of ANY jax function — including the fully
autodiffed train step — by tracing it to a jaxpr (no compile, no execution)
and walking the equations:

- dot_general:            2 * prod(out_shape) * prod(contracting_dims)
- conv_general_dilated:   2 * prod(out_shape) * K_spatial * C_in / groups

Elementwise/reduction ops are ignored: they are bandwidth-bound; the
matmul/conv terms (tensor-core work on the GPU) are what MFU is defined
against. Nested jaxprs
(pjit, custom_vjp, remat, scan, cond) are traversed; scan bodies multiply by
trip count, cond takes the most expensive branch.
"""

from __future__ import annotations

import math
from typing import Any

import jax


def _prod(xs) -> int:
    return int(math.prod(int(x) for x in xs))


def _dot_general_flops(eqn) -> int:
    (lhs_c, _), _ = eqn.params["dimension_numbers"]
    lhs_shape = eqn.invars[0].aval.shape
    out_shape = eqn.outvars[0].aval.shape
    contract = _prod(lhs_shape[d] for d in lhs_c)
    return 2 * _prod(out_shape) * contract


def _conv_flops(eqn) -> int:
    dn = eqn.params["dimension_numbers"]
    rhs_shape = eqn.invars[1].aval.shape
    out_shape = eqn.outvars[0].aval.shape
    groups = int(eqn.params.get("feature_group_count", 1))
    # rhs_spec = (out_feature_dim, in_feature_dim, *spatial_dims)
    rhs_spec = dn.rhs_spec
    c_in_per_group = rhs_shape[rhs_spec[1]]  # already divided by groups
    k_spatial = _prod(rhs_shape[d] for d in rhs_spec[2:])
    return 2 * _prod(out_shape) * k_spatial * c_in_per_group


def _jaxpr_flops(jaxpr) -> int:
    total = 0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            total += _dot_general_flops(eqn)
        elif name == "conv_general_dilated":
            total += _conv_flops(eqn)
        elif name == "scan":
            body = eqn.params["jaxpr"]
            total += int(eqn.params["length"]) * _jaxpr_flops(body.jaxpr)
        elif name == "while":
            # trip count is dynamic; count one body iteration (conservative)
            total += _jaxpr_flops(eqn.params["body_jaxpr"].jaxpr)
        elif name == "cond":
            total += max(
                (_jaxpr_flops(b.jaxpr) for b in eqn.params["branches"]),
                default=0)
        else:
            # generic containers: pjit, custom_vjp/jvp_call, remat/checkpoint...
            for value in eqn.params.values():
                total += _maybe_nested_flops(value)
    return total


def _maybe_nested_flops(value: Any) -> int:
    if hasattr(value, "jaxpr") and hasattr(value, "eqns") is False:
        # ClosedJaxpr
        return _jaxpr_flops(value.jaxpr)
    if hasattr(value, "eqns"):  # raw Jaxpr
        return _jaxpr_flops(value)
    if isinstance(value, (tuple, list)):
        return sum(_maybe_nested_flops(v) for v in value)
    return 0


def matmul_flops(fn, *args, **kwargs) -> int:
    """Exact matmul/conv FLOPs of one call of `fn` on these args.

    Traces to a jaxpr on the current backend — cheap (no compilation; though
    tracing a fully-autodiffed 4-network step still costs ~1 min of host CPU
    on a small host). For a train step this includes the backward pass, since
    autodiff is part of the traced function."""
    jaxpr = jax.make_jaxpr(lambda *a: fn(*a, **kwargs))(*args)
    return _jaxpr_flops(jaxpr.jaxpr)


def _args_signature(args) -> str:
    import json

    sig = jax.tree.map(lambda x: [list(getattr(x, "shape", ())),
                                  str(getattr(x, "dtype", type(x).__name__))],
                       args)
    return json.dumps(sig, sort_keys=True, default=str)


def matmul_flops_cached(fn, *args, salt: str = "",
                        cache_path: str | None = None, **kwargs) -> int:
    """matmul_flops with a persistent JSON cache (bench.py: the host-side
    jaxpr trace of the train step costs ~1 min per section on a 1-core
    host — half the bench budget across four sections).

    The key hashes: `salt` (the caller passes the full config dict — any
    config change invalidates), the args' tree structure + shapes + dtypes
    (any architecture change that moves a parameter or input shape
    invalidates), and the jax version. A model-code edit that changes the
    program while preserving every shape AND the config would alias — delete
    the cache file (or set SCRABBLEGAN_FLOPS_NO_CACHE=1) after such an edit.
    """
    import hashlib
    import json
    import os

    if not cache_path or os.environ.get("SCRABBLEGAN_FLOPS_NO_CACHE"):
        return matmul_flops(fn, *args, **kwargs)
    key = hashlib.sha256(
        (salt + "|" + _args_signature(args) + "|" + jax.__version__)
        .encode()).hexdigest()[:32]
    cache = {}
    if os.path.isfile(cache_path):
        try:
            with open(cache_path) as f:
                cache = json.load(f)
        except (OSError, ValueError):
            cache = {}
    if key in cache:
        return int(cache[key]["flops"])
    flops = matmul_flops(fn, *args, **kwargs)
    cache[key] = {"flops": int(flops),
                  "note": salt[:120]}
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    with open(cache_path, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
        f.write("\n")
    return flops

"""Model summaries — the analog of the reference's `model.summary()` prints
(vis_model=True on every builder, e.g. net_architecture.py:293-294): per-network
parameter counts.
"""

from __future__ import annotations

from typing import Any

import jax


def param_breakdown(params: Any, top_level: bool = True) -> dict:
    """{submodule: parameter count} for a params pytree."""
    if not isinstance(params, dict):
        return {"": sum(x.size for x in jax.tree_util.tree_leaves(params))}
    return {
        name: sum(x.size for x in jax.tree_util.tree_leaves(sub))
        for name, sub in params.items()
    }


def summarize_state(state, verbose_print=print) -> dict:
    """Per-network param counts for a TrainState; returns {net: count}."""
    counts = {}
    for net, params in (("generator", state.g_params),
                        ("discriminator", state.d_params),
                        ("recognizer", state.r_params),
                        ("style_promoter", state.w_params)):
        n = sum(x.size for x in jax.tree_util.tree_leaves(params))
        counts[net] = n
        verbose_print(f"  {net:<16} {n / 1e6:7.2f}M params")
    verbose_print(f"  {'total':<16} {sum(counts.values()) / 1e6:7.2f}M params")
    return counts

"""Checkpoint/resume of the FULL train state, as numpy archives.

Upgrades the reference's vestigial tf.train.Checkpoint — constructed but never
saved or restored (main.py:93-102; SURVEY.md component 22/defect #6) — to real
fault tolerance: all four networks' params, BN/SN statistics, all four optimizer
states, and the step counter are saved per epoch and restored on start. A
generator-only export (save_generator) mirrors the reference's per-epoch
`generator.save_weights` consumed by run_inference.py.

Layout: `<ckpt_dir>/<step>/state.npz` (the newest `max_to_keep` steps are
kept) and `<model_dir>/<net>/<epoch>/variables.npz`. An archive holds one
array per leaf plus `__index__`, a JSON list of each leaf's tree path and
dtype; dtypes numpy cannot store (bfloat16) are kept as raw bits. A save
writes a temporary directory and renames it into place, so a reader sees a
whole checkpoint or none.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from scrabblegan.train.state import TrainState

_STATE_FILE = "state.npz"
_EXPORT_FILE = "variables.npz"


def _path_parts(path) -> list:
    parts = []
    for k in path:
        if isinstance(k, jax.tree_util.DictKey):
            parts.append(k.key)
        elif isinstance(k, jax.tree_util.GetAttrKey):
            parts.append(k.name)
        elif isinstance(k, jax.tree_util.SequenceKey):
            parts.append(k.idx)
        elif isinstance(k, jax.tree_util.FlattenedIndexKey):
            parts.append(k.key)
        else:
            raise TypeError(f"unsupported tree key {k!r}")
    return parts


def _write_tree(out_dir: str, filename: str, tree: Any) -> str:
    """Write `tree` to out_dir/filename, replacing out_dir as a whole."""
    out_dir = os.path.abspath(out_dir)
    parent = os.path.dirname(out_dir)
    os.makedirs(parent, exist_ok=True)
    arrays, index = {}, []
    for i, (path, leaf) in enumerate(jax.tree_util.tree_flatten_with_path(tree)[0]):
        a = np.asarray(jax.device_get(leaf))
        index.append({"path": _path_parts(path), "dtype": a.dtype.name})
        arrays[f"a{i}"] = a.view(f"u{a.dtype.itemsize}") if a.dtype.kind == "V" else a
    tmp = tempfile.mkdtemp(prefix=".tmp-", dir=parent)
    try:
        with open(os.path.join(tmp, filename), "wb") as f:
            np.savez(f, __index__=np.frombuffer(json.dumps(index).encode(), np.uint8),
                     **arrays)
        if os.path.exists(out_dir):
            old = tempfile.mkdtemp(prefix=".old-", dir=parent)
            os.replace(out_dir, os.path.join(old, "x"))
            os.replace(tmp, out_dir)
            shutil.rmtree(old)
        else:
            os.replace(tmp, out_dir)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return out_dir


def _read_leaves(file: str) -> dict:
    """{tuple(tree path): numpy array} of an archive."""
    with np.load(file) as z:
        index = json.loads(z["__index__"].tobytes().decode())
        out = {}
        for i, entry in enumerate(index):
            a = z[f"a{i}"]
            if a.dtype.name != entry["dtype"]:
                a = a.view(jnp.dtype(entry["dtype"]))
            out[tuple(entry["path"])] = a
    return out


def _steps(ckpt_dir: str) -> list:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir)
                  if d.isdigit() and os.path.isfile(os.path.join(ckpt_dir, d, _STATE_FILE)))


def save_state(ckpt_dir: str, state: TrainState, step: int,
               max_to_keep: int = 3) -> str:
    path = _write_tree(os.path.join(ckpt_dir, str(int(step))), _STATE_FILE, state)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)
    return path


def restore_state(ckpt_dir: str, template: TrainState) -> Tuple[Optional[TrainState], int]:
    """Restore the latest checkpoint into the template's structure, placing
    each leaf with the template leaf's sharding.

    Returns (state, step) or (None, 0) when no checkpoint exists."""
    steps = _steps(ckpt_dir)
    if not steps:
        return None, 0
    step = steps[-1]
    stored = _read_leaves(os.path.join(ckpt_dir, str(step), _STATE_FILE))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    for path, leaf in leaves:
        key = tuple(_path_parts(path))
        if key not in stored:
            raise ValueError(f"checkpoint step {step} lacks leaf {key}")
        a = stored.pop(key)
        if a.shape != tuple(leaf.shape) or a.dtype != leaf.dtype:
            raise ValueError(f"checkpoint leaf {key} is {a.dtype}{a.shape}, "
                             f"template wants {leaf.dtype}{tuple(leaf.shape)}")
        sharding = getattr(leaf, "sharding", None)
        out.append(jax.device_put(a, sharding) if sharding is not None
                   else jnp.asarray(a))
    if stored:
        raise ValueError(f"checkpoint step {step} has leaves the template "
                         f"lacks: {sorted(stored)[:5]}")
    return treedef.unflatten(out), step


def save_generator(model_dir: str, g_params: Any, g_stats: Any, epoch: int) -> str:
    """Generator-only export for inference (parity with data_utils.py:346 +
    run_inference.py's saved-model consumption)."""
    return _save_net(model_dir, "generator", g_params, g_stats, epoch)


def save_recognizer(model_dir: str, r_params: Any, r_stats: Any, epoch: int) -> str:
    """Recognizer-only per-epoch export (parity with data_utils.py:347-348 —
    the reference saves R weights alongside G every epoch). Lets the rFID/CER
    feature extractor be rebuilt from ANY epoch without the full-state
    checkpoint (which only lands every io.ckpt_every epochs)."""
    return _save_net(model_dir, "recognizer", r_params, r_stats, epoch)


def _save_net(model_dir: str, name: str, params: Any, stats: Any, epoch: int) -> str:
    return _write_tree(os.path.join(model_dir, name, str(epoch)), _EXPORT_FILE,
                       {"params": params, "batch_stats": stats})


def load_generator(path: str) -> dict:
    """An export's {params, batch_stats} as nested dicts of numpy arrays."""
    tree: dict = {}
    for key, a in _read_leaves(os.path.join(path, _EXPORT_FILE)).items():
        node = tree
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = a
    return tree


# R exports share the {params, batch_stats} layout of G exports
load_recognizer = load_generator


def latest_generator_export(model_dir: str) -> Optional[str]:
    return _latest_export(model_dir, "generator")


def latest_recognizer_export(model_dir: str) -> Optional[str]:
    return _latest_export(model_dir, "recognizer")


def _latest_export(model_dir: str, name: str) -> Optional[str]:
    root = os.path.join(model_dir, name)
    if not os.path.isdir(root):
        return None
    epochs = [int(d) for d in os.listdir(root) if d.isdigit()]
    if not epochs:
        return None
    return os.path.join(root, str(max(epochs)))

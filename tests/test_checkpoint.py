"""Numpy checkpoints (train/checkpoint.py): round trips, dtypes, retention,
atomic replacement and a restore onto sharded templates."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from scrabblegan.train import checkpoint as ckpt
from scrabblegan.train.state import TrainState


def _state(step=3, scale=1.0):
    tree = lambda k: {"conv": {"kernel": scale * jnp.arange(24.0).reshape(8, 3) + k,
                               "Conv_0/kernel/u": jnp.ones((1, 3)) * k}}
    return TrainState(
        step=jnp.asarray(step, jnp.int32),
        g_params=tree(1), g_stats={"bn": {"mean": jnp.zeros(3)}},
        d_params=tree(2), d_stats={}, r_params=tree(3), r_stats={},
        w_params=tree(4), w_stats={},
        g_opt=(jnp.ones(2, jnp.bfloat16), {"nu": tree(5)}), d_opt=(), r_opt=(),
        w_opt=(), g_ema=None)


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32), np.asarray(y, np.float32))


def test_state_round_trip_keeps_dtypes_and_slashed_keys(tmp_path):
    state = _state()
    ckpt.save_state(str(tmp_path), state, 3)
    restored, step = ckpt.restore_state(str(tmp_path), _state(step=0, scale=0.0))
    assert step == 3
    _assert_trees_equal(restored, state)
    assert restored.g_opt[0].dtype == jnp.bfloat16


def test_no_checkpoint_and_mismatched_template(tmp_path):
    assert ckpt.restore_state(str(tmp_path / "none"), _state()) == (None, 0)
    ckpt.save_state(str(tmp_path), _state(), 1)
    other = _state().replace(d_opt=(jnp.zeros(2),))
    with pytest.raises(ValueError, match="has leaves|lacks leaf"):
        ckpt.restore_state(str(tmp_path), other)


def test_keeps_newest_and_replaces_whole_dirs(tmp_path):
    for step in (1, 2, 3, 4):
        ckpt.save_state(str(tmp_path), _state(step), step, max_to_keep=3)
    assert sorted(os.listdir(tmp_path)) == ["2", "3", "4"]
    ckpt.save_state(str(tmp_path), _state(4, scale=2.0), 4)  # overwrite in place
    restored, step = ckpt.restore_state(str(tmp_path), _state())
    assert step == 4 and float(restored.g_params["conv"]["kernel"][1, 0]) == 7.0
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".")]


def test_generator_export_round_trip(tmp_path):
    params = {"up_B1": {"kernel": np.arange(6.0).reshape(2, 3)},
              "filter_bank": {"filter_bank": np.ones((2, 2), np.float32)}}
    stats = {"SNConv_0": {"SpectralNorm_0": {"Conv_0/kernel/u": np.ones((1, 3))}}}
    path = ckpt.save_generator(str(tmp_path), params, stats, 2)
    assert ckpt.latest_generator_export(str(tmp_path)) == path
    _assert_trees_equal(ckpt.load_generator(path),
                        {"params": params, "batch_stats": stats})


def test_sharded_restore_on_virtual_devices(tmp_path):
    devices = jax.devices()
    assert len(devices) == 8
    mesh = Mesh(np.array(devices), ("data",))
    split = NamedSharding(mesh, P("data"))
    state = _state()
    ckpt.save_state(str(tmp_path), state, 3)
    template = jax.tree.map(
        lambda x: jax.device_put(x, split if x.ndim and x.shape[0] % 8 == 0
                                 else NamedSharding(mesh, P())), _state(0, 0.0))
    restored, _ = ckpt.restore_state(str(tmp_path), template)
    kernel = restored.g_params["conv"]["kernel"]
    assert kernel.sharding == split
    assert kernel.sharding.shard_shape(kernel.shape) == (1, 3)
    _assert_trees_equal(restored, state)

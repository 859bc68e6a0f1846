"""The ``.npz`` checkpoint manager and the ``TrainState`` pytree."""
import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bodyct_dram_emph_subtype.train import (CheckpointManager, TrainState,
                                            make_optimizer)


def _state(seed=0):
    params = {"conv": {"kernel": jnp.full((3, 3, 3, 1, 4), float(seed))},
              "bn": {"scale": jnp.ones(4), "bias": jnp.zeros(4)}}
    state = TrainState.create({"params": params,
                               "batch_stats": {"bn": {"mean": jnp.zeros(4)}}},
                              make_optimizer())
    return state.replace(step=jnp.asarray(seed, jnp.int32))


def _equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_roundtrip_keeps_every_epoch_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt")
    assert mgr.latest_epoch() is None
    extras = {"cle_class_weights": np.arange(6.0),
              "pse_class_weights": np.arange(3.0)}
    for epoch in range(3):
        mgr.save(epoch, _state(epoch), extras=extras)
    assert mgr.epochs() == [0, 1, 2] and mgr.latest_epoch() == 2
    state, got_extras, epoch = mgr.restore(_state(9))
    assert epoch == 2
    _equal(state, _state(2))
    np.testing.assert_array_equal(got_extras["cle_class_weights"],
                                  extras["cle_class_weights"])
    state1, _, _ = mgr.restore(_state(9), epoch=1)
    _equal(state1, _state(1))
    # a fresh manager on the same directory resumes from the newest epoch
    assert CheckpointManager(tmp_path / "ckpt").latest_epoch() == 2


def test_restore_places_leaves_like_the_template(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, _state(1))
    template = jax.device_put(_state(5), jax.devices()[3])
    state, _, _ = mgr.restore(template)
    leaf = jax.tree.leaves(state)[0]
    assert isinstance(leaf, jax.Array)
    assert leaf.devices() == {jax.devices()[3]}
    _equal(state, _state(1))


def test_failed_write_leaves_no_checkpoint(tmp_path, monkeypatch):
    """A save that dies mid-write leaves neither a partial epoch file nor
    its temporary."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, _state(0))

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError):
        mgr.save(1, _state(1))
    assert sorted(os.listdir(tmp_path)) == ["epoch_0.npz"]
    assert mgr.latest_epoch() == 0


def test_restore_rejects_a_different_model(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(0, _state(0))
    other = _state(0).replace(
        params={"conv": {"kernel": jnp.zeros((3, 3, 3, 1, 8))},
                "bn": {"scale": jnp.ones(4), "bias": jnp.zeros(4)}})
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(other)
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(_state(0))


def test_train_state_is_a_pytree_with_donation():
    state = _state(3)
    leaves, treedef = jax.tree.flatten(state)
    assert len(leaves) == len(jax.tree.leaves(state.params)) + len(
        jax.tree.leaves(state.batch_stats)) + len(
        jax.tree.leaves(state.opt_state)) + 2
    _equal(jax.tree.unflatten(treedef, leaves), state)
    assert state.variables == {"params": state.params,
                               "batch_stats": state.batch_stats}

    bump = jax.jit(lambda s: s.replace(step=s.step + 1,
                                       params=jax.tree.map(lambda p: p * 2,
                                                           s.params)),
                   donate_argnums=0)
    new = bump(_state(3))
    assert int(new.step) == 4
    np.testing.assert_array_equal(np.asarray(new.params["conv"]["kernel"]),
                                  6.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        new.step = 0

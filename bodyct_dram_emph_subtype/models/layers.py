"""A minimal functional module layer: named variables, BatchNorm state,
rematerialisation.

Models are frozen dataclasses whose ``__call__(scope, ...)`` reads its
variables through a :class:`Scope`.  ``Module.init(rng, *args)`` returns
``{"params": ..., "batch_stats": ...}`` nested by module name, and
``Module.apply(variables, *args, mutable=["batch_stats"])`` returns
``(out, {"batch_stats": updated})`` — the layout that torch-checkpoint
import (``models/torch_import.py``), ``.npz`` weights and saved train
states address by path.

Initial values are drawn per variable from the root key folded with the
variable's module path and its position in the module (a SHA-1 of the
names), so a parameter's initial value does not depend on what the rest of
the model declares.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

Path = Tuple[str, ...]


def _fold_in_path(rng, data: Sequence[Any]):
    m = hashlib.sha1()
    for x in data:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    return jax.random.fold_in(
        rng, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


def _subtree(tree: Dict[str, Any], path: Path, create: bool):
    for name in path:
        tree = tree.setdefault(name, {}) if create else tree.get(name, {})
    return tree


def _replace_leaves(tree, updates: Dict[Path, Any], prefix: Path = ()):
    if not isinstance(tree, dict):
        return updates.get(prefix, tree)
    return {k: _replace_leaves(v, updates, prefix + (k,))
            for k, v in tree.items()}


class _Store:
    """Variables of one ``init``/``apply`` call and the BatchNorm updates it
    collects (keyed by full path)."""

    def __init__(self, variables: Dict[str, Any], rng=None):
        self.variables = variables
        self.rng = rng
        self.updates: Dict[Path, Any] = {}


class Scope:
    """A module's view of the variables: ``param``/``stat`` read (or, under
    ``init``, create) variables under this scope's path."""

    def __init__(self, store: _Store, path: Path = ()):
        self._store = store
        self.path = path
        self._n_params = 0

    @property
    def initializing(self) -> bool:
        return self._store.rng is not None

    def child(self, name: str) -> "Scope":
        return Scope(self._store, self.path + (name,))

    def _get(self, col: str, name: str, make: Callable[[], Any]):
        node = _subtree(self._store.variables.setdefault(col, {}), self.path,
                        create=self.initializing)
        if name not in node:
            if not self.initializing:
                raise KeyError(f"missing variable {col}/"
                               f"{'/'.join(self.path + (name,))}")
            node[name] = make()
        return node[name]

    def param(self, name: str, init_fn, shape) -> jax.Array:
        self._n_params += 1
        n = self._n_params

        def make():
            key = _fold_in_path(self._store.rng, self.path + (n,))
            return init_fn(key, tuple(shape), jnp.float32)
        return self._get("params", name, make)

    def stat(self, name: str, init_fn, shape) -> jax.Array:
        """A ``batch_stats`` variable (no random init)."""
        return self._get("batch_stats", name,
                         lambda: init_fn(None, tuple(shape), jnp.float32))

    def set_stat(self, name: str, value) -> None:
        if not self.initializing:
            self._store.updates[self.path + (name,)] = value

    def checkpointed(self, fn: Callable, *xs, train: bool):
        """``fn(self, *xs, train)`` under ``jax.checkpoint``: the backward
        pass recomputes ``fn``'s activations instead of keeping them."""
        if self.initializing:
            return fn(self, *xs, train)

        def run(params, stats, *xs):
            store = _Store({"params": params, "batch_stats": stats})
            y = fn(Scope(store), *xs, train)
            return y, store.updates

        variables = self._store.variables
        y, updates = jax.checkpoint(run)(
            _subtree(variables.get("params", {}), self.path, False),
            _subtree(variables.get("batch_stats", {}), self.path, False),
            *xs)
        for path, value in updates.items():
            self._store.updates[self.path + path] = value
        return y


class Module:
    """Base for frozen-dataclass modules: ``__call__(scope, *args)``."""

    def init(self, rng, *args, **kwargs) -> Dict[str, Any]:
        store = _Store({"params": {}, "batch_stats": {}}, rng)
        self(Scope(store), *args, **kwargs)
        return store.variables

    def apply(self, variables: Dict[str, Any], *args,
              mutable: Sequence[str] = (), **kwargs):
        store = _Store(dict(variables))
        out = self(Scope(store), *args, **kwargs)
        if not mutable:
            return out
        return out, {col: _replace_leaves(store.variables.get(col, {}),
                                          store.updates)
                     for col in mutable}


module = dataclasses.dataclass(frozen=True)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

kaiming_normal_fan_out = jax.nn.initializers.variance_scaling(
    2.0, "fan_out", "normal")  # == torch kaiming_normal_(mode='fan_out')
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones


def batch_norm(s: Scope, x, train: bool, *, momentum: float = 0.9,
               epsilon: float = 1e-5, affine: bool = True,
               use_running_average: Optional[bool] = None, dtype=None):
    """BatchNorm over every axis but the last.  Statistics in float32 with
    E[x²]−E[x]² (clipped at 0); running averages move by ``1 − momentum``
    toward the biased batch statistics.  Under a data-sharded jit the
    reduction is global: SyncBatchNorm semantics."""
    c = x.shape[-1]
    axes = tuple(range(x.ndim - 1))
    ra_mean = s.stat("mean", zeros, (c,))
    ra_var = s.stat("var", ones, (c,))
    if use_running_average is None:
        use_running_average = not train
    if use_running_average:
        mean, var = ra_mean, ra_var
    else:
        xf = x.astype(jnp.promote_types(dtype or x.dtype, jnp.float32))
        mean = xf.mean(axes)
        var = jnp.maximum(0.0, jax.lax.square(xf).mean(axes)
                          - jax.lax.square(mean))
        s.set_stat("mean", momentum * ra_mean + (1 - momentum) * mean)
        s.set_stat("var", momentum * ra_var + (1 - momentum) * var)
    y = x - mean
    mul = jax.lax.rsqrt(var + epsilon)
    if affine:
        mul = mul * s.param("scale", ones, (c,))
    y = y * mul
    if affine:
        y = y + s.param("bias", zeros, (c,))
    return y.astype(dtype or jnp.result_type(x, jnp.float32))


def group_norm(s: Scope, x, num_groups: int, *, epsilon: float = 1e-5,
               affine: bool = True, dtype=None):
    """GroupNorm over (spatial, channels-of-group) per sample."""
    c = x.shape[-1]
    xf = x.astype(jnp.float32)
    g = xf.reshape(*x.shape[:-1], num_groups, c // num_groups)
    axes = tuple(range(1, x.ndim - 1)) + (x.ndim,)
    mean = g.mean(axes, keepdims=True)
    var = jnp.maximum(0.0, jax.lax.square(g).mean(axes, keepdims=True)
                      - jax.lax.square(mean))
    y = ((g - mean) * jax.lax.rsqrt(var + epsilon)).reshape(x.shape)
    if affine:
        y = y * s.param("scale", ones, (c,)) + s.param("bias", zeros, (c,))
    return y.astype(dtype or jnp.result_type(x, jnp.float32))


def max_pool_3d(x, window: int, stride: int, pad: int):
    """Max-pool over (D, H, W) of an NDHWC volume, -inf padding.  The
    Python-scalar init keeps ``reduce_window`` on its differentiable
    max-monoid path."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        (1, window, window, window, 1), (1, stride, stride, stride, 1),
        ((0, 0),) + ((pad, pad),) * 3 + ((0, 0),))


relu = jax.nn.relu

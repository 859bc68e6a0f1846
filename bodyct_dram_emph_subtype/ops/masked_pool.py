"""Lobe-masked pooling: the dRAM head's lesion-fraction reduction.

Reference semantics (``med3d.py:386-387``): nearest-resize the lung mask to
the dense-map resolution, then per sample
``reg = sum(dense * lung) / sum(lung)``.

This is a bandwidth-bound reduction that XLA fuses with the sigmoid head;
the jnp implementation below compiles to a single fused multiply-reduce.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .resize import resize_nearest


def lung_masked_fraction(dense: jax.Array, lung: jax.Array,
                         eps: float = 0.0) -> jax.Array:
    """Per-sample masked mean over NDHWC dense maps.

    ``dense``: (B, D, H, W, C); ``lung``: (B, D', H', W', 1) at any resolution
    — it is nearest-resized to the dense resolution first, exactly like the
    reference (``med3d.py:386``).  Returns (B, C).
    """
    if lung.shape[1:4] != dense.shape[1:4]:
        lung = resize_nearest(lung, dense.shape[1:4], (1, 2, 3))
    lung = lung.astype(dense.dtype)
    num = jnp.sum(dense * lung, axis=(1, 2, 3))
    den = jnp.sum(lung, axis=(1, 2, 3))
    return num / (den + eps)

"""Binary morphology + bounding-box ops used by the inference preprocessing.

The reference preprocesses each deployment scan on the host with scipy
(``dataset.py:68-71``): lung = lobe>0, dilate twice with the *full* 3x3x3
structuring element, mask everything outside to -2048 HU, then crop to the
lung bounding box padded by ``border`` millimetres (``utils.py:53-63``).

Device versions: binary dilation with a full box structure is a max-pool
(``lax.reduce_window``), and the bounding box is an axis-reduction + argmax —
both fuse into the on-device preprocess.  NumPy fallbacks are provided for
host-side use on variable-size volumes.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def binary_dilate(mask: jax.Array, iterations: int = 1) -> jax.Array:
    """Binary dilation with the full 3^ndim structuring element == max-pool.

    Equivalent to ``scipy.ndimage.binary_dilation(mask,
    generate_binary_structure(3, 3), iterations=N)`` (reference
    ``dataset.py:69``): N iterations of a 3-box dilation equal one max-pool
    with a (2N+1)-box window.
    """
    if iterations <= 0:
        return mask
    k = 2 * iterations + 1
    x = mask.astype(jnp.float32)
    out = jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max,
        window_dimensions=(k,) * x.ndim,
        window_strides=(1,) * x.ndim,
        padding=[(iterations, iterations)] * x.ndim)
    return out > 0.5


def mask_bbox(mask: jax.Array) -> jax.Array:
    """(ndim, 2) [start, stop) bounds of the nonzero region of ``mask``.

    Device analog of ``scipy.ndimage.find_objects`` for a single object
    (reference ``utils.py:53-63``).  Works under jit: output shape is static.
    """
    ndim = mask.ndim
    m = mask > 0
    bounds = []
    for axis in range(ndim):
        other = tuple(a for a in range(ndim) if a != axis)
        line = jnp.any(m, axis=other)
        n = line.shape[0]
        idx = jnp.arange(n, dtype=jnp.int32)
        start = jnp.min(jnp.where(line, idx, n))
        stop = jnp.max(jnp.where(line, idx + 1, 0))
        bounds.append(jnp.stack([start, stop]))
    return jnp.stack(bounds)


def pad_bbox_mm(bbox: jax.Array, shape: Sequence[int], spacing: Sequence[float],
                border_mm: float) -> jax.Array:
    """Pad a bbox by ``border_mm`` millimetres per axis, clipped to the volume.

    Matches the reference ``find_crops`` padding
    ``ceil(border / spacing)`` (``utils.py:56-59``).
    """
    pads = jnp.asarray([int(math.ceil(border_mm / float(sp))) for sp in spacing],
                       jnp.int32)
    starts = jnp.maximum(0, bbox[:, 0] - pads)
    stops = jnp.minimum(jnp.asarray(shape, jnp.int32), bbox[:, 1] + pads)
    return jnp.stack([starts, stops], axis=-1)


# ---------------------------------------------------------------- host (numpy)

def binary_dilate_np(mask: np.ndarray, iterations: int = 1) -> np.ndarray:
    """NumPy max-filter dilation with the full box structure (host fallback)."""
    if iterations <= 0:
        return mask.astype(bool)
    out = mask.astype(bool)
    for axis in range(mask.ndim):
        acc = out.copy()
        for shift in range(1, iterations + 1):
            acc |= _shift_bool(out, shift, axis)
            acc |= _shift_bool(out, -shift, axis)
        out = acc
    return out


def _shift_bool(a: np.ndarray, shift: int, axis: int) -> np.ndarray:
    out = np.zeros_like(a)
    src = [slice(None)] * a.ndim
    dst = [slice(None)] * a.ndim
    if shift > 0:
        dst[axis] = slice(shift, None)
        src[axis] = slice(None, -shift)
    else:
        dst[axis] = slice(None, shift)
        src[axis] = slice(-shift, None)
    out[tuple(dst)] = a[tuple(src)]
    return out


def find_crops_np(mask: np.ndarray, spacing: Sequence[float],
                  border_mm: float) -> Tuple[slice, ...]:
    """Host bbox-with-border crop slices, parity with ``utils.py:53-63``.

    Per-axis ``any`` reductions + argmax instead of ``np.nonzero``: the
    latter materializes index arrays for every nonzero voxel (hundreds of
    MB for a deployment lung mask), while the reductions stream the volume
    twice with no allocation — the bbox is identical."""
    m = mask if mask.dtype == np.bool_ else mask > 0
    if m.ndim == 3:
        zy = m.any(axis=2)
        lines = [zy.any(axis=1), zy.any(axis=0), m.any(axis=(0, 1))]
    else:
        lines = [m.any(axis=tuple(a for a in range(m.ndim) if a != axis))
                 for axis in range(m.ndim)]
    slices = []
    for axis, line in enumerate(lines):
        start = int(line.argmax())
        if not line[start]:
            raise ValueError("empty mask: no nonzero voxels to crop")
        stop = len(line) - int(line[::-1].argmax())
        if border_mm > 0:
            pad = int(math.ceil(border_mm / float(spacing[axis])))
            start = max(0, start - pad)
            stop = min(mask.shape[axis], stop + pad)
        slices.append(slice(start, stop))
    return tuple(slices)

"""ROI-align / crop-and-resize with torch ``affine_grid``+``grid_sample`` parity.

The reference implements its crop-resize augmentation as a normalized-box
affine grid + grid sample (``functional.py:67-94``) driven by the
``CropAndResize`` transform (``spatial_transforms.py:133-197``).  The affine
matrix is always *axis-aligned* (diagonal scale + shift), so the sampling is
separable per axis; we exploit this to implement it as three cheap 1-D
gather/lerp passes instead of a full 3-D gather — far friendlier to XLA
fusion.

Convention subtleties replicated exactly:
- ``affine_grid`` is called *without* ``align_corners`` → ``False``: the base
  grid is ``linspace(-1, 1, S) * (S-1)/S``.
- for images, ``grid_sample(..., align_corners=True)`` unnormalizes with
  ``ix = (x+1)/2*(S-1)``; for masks ``align_corners=False`` gives
  ``ix = ((x+1)*S-1)/2``; padding_mode='zeros' zeroes out-of-bounds taps;
  nearest mode rounds half-to-even (``std::nearbyint``), matching
  ``jnp.round``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _base_grid_1d(out_size: int) -> jax.Array:
    """torch ``affine_grid`` base coords with align_corners=False."""
    if out_size == 1:
        return jnp.zeros((1,), jnp.float32)
    lin = jnp.linspace(-1.0, 1.0, out_size, dtype=jnp.float32)
    return lin * (out_size - 1) / out_size


def _unnormalize(coords: jax.Array, in_size: int, align_corners: bool) -> jax.Array:
    if align_corners:
        return (coords + 1.0) / 2.0 * (in_size - 1)
    return ((coords + 1.0) * in_size - 1.0) / 2.0


def _axis_taps_linear(coords: jax.Array, in_size: int):
    """Corner indices/weights with zero-padding validity for linear sampling."""
    i0 = jnp.floor(coords).astype(jnp.int32)
    i1 = i0 + 1
    w1 = coords - i0.astype(jnp.float32)
    w0 = 1.0 - w1
    v0 = (i0 >= 0) & (i0 <= in_size - 1)
    v1 = (i1 >= 0) & (i1 <= in_size - 1)
    i0c = jnp.clip(i0, 0, in_size - 1)
    i1c = jnp.clip(i1, 0, in_size - 1)
    return (i0c, w0 * v0), (i1c, w1 * v1)


def _tap_matrix_linear(coords: jax.Array, in_size: int) -> jax.Array:
    """Dense (out, in) linear-interp matrix from dynamic coords: row i holds
    the two corner weights at columns i0/i1 (zero-padded out of bounds).
    Matches :func:`_axis_taps_linear` exactly."""
    j = jnp.arange(in_size, dtype=jnp.int32)[None, :]
    (i0, w0), (i1, w1) = _axis_taps_linear(coords, in_size)
    return (w0[:, None] * (j == i0[:, None])
            + w1[:, None] * (j == i1[:, None])).astype(jnp.float32)


def _tap_matrix_nearest(coords: jax.Array, in_size: int) -> jax.Array:
    """Dense (out, in) one-hot nearest matrix (round-half-to-even, zeros
    out of bounds) from dynamic coords."""
    j = jnp.arange(in_size, dtype=jnp.int32)[None, :]
    idx = jnp.round(coords).astype(jnp.int32)
    valid = (idx >= 0) & (idx <= in_size - 1)
    idxc = jnp.clip(idx, 0, in_size - 1)
    return ((j == idxc[:, None]) & valid[:, None]).astype(jnp.float32)


def axis_aligned_grid_sample(vol: jax.Array, box01: jax.Array,
                             out_sizes: Sequence[int], mode: str,
                             align_corners: bool,
                             via: str = "gather") -> jax.Array:
    """Sample an axis-aligned normalized box from ``vol`` (trailing dims spatial).

    ``box01``: (ndim, 2) array of (start, stop) fractions of each spatial dim,
    exactly the normalized bounding box the reference feeds into
    ``compute_crop_resize_affine_matrix`` (``functional.py:67-76``): an output
    base coordinate ``t`` maps to input normalized coordinate
    ``t*(b1-b0) + (b0+b1-1)``.
    """
    ndim = len(out_sizes)
    spatial_axes = list(range(vol.ndim - ndim, vol.ndim))
    out = vol.astype(jnp.float32) if mode == "bilinear" else vol
    for k, axis in enumerate(spatial_axes):
        in_size = vol.shape[axis]
        t = _base_grid_1d(out_sizes[k])
        b0, b1 = box01[k, 0], box01[k, 1]
        norm = t * (b1 - b0) + (b0 + b1 - 1.0)
        coords = _unnormalize(norm, in_size, align_corners)
        if via == "matmul":
            # matmul path for dynamic (traced) boxes: per-axis tensordot
            # against a dense tap matrix instead of full-volume gathers
            m = (_tap_matrix_linear(coords, in_size) if mode == "bilinear"
                 else _tap_matrix_nearest(coords, in_size))
            out = jnp.tensordot(out.astype(jnp.float32), m,
                                axes=([axis], [1]),
                                precision=jax.lax.Precision.HIGHEST)
            out = jnp.moveaxis(out, -1, axis)
            continue
        if mode == "bilinear":
            (i0, w0), (i1, w1) = _axis_taps_linear(coords, in_size)
            bshape = [1] * out.ndim
            bshape[axis] = out_sizes[k]
            out = (jnp.take(out, i0, axis=axis) * w0.reshape(bshape)
                   + jnp.take(out, i1, axis=axis) * w1.reshape(bshape))
        elif mode == "nearest":
            idx = jnp.round(coords).astype(jnp.int32)
            valid = (idx >= 0) & (idx <= in_size - 1)
            idxc = jnp.clip(idx, 0, in_size - 1)
            bshape = [1] * out.ndim
            bshape[axis] = out_sizes[k]
            taken = jnp.take(out, idxc, axis=axis)
            out = taken * valid.reshape(bshape).astype(taken.dtype)
        else:
            raise ValueError(f"unsupported mode: {mode}")
    return out


def _crop_box01(shape: Tuple[int, ...], crop_center: jax.Array,
                crop_size: jax.Array) -> jax.Array:
    """The reference ``CropAndResize`` integer box arithmetic
    (``spatial_transforms.py:170-181``) as a normalized (ndim, 2) box."""
    shape_f = jnp.asarray(shape, jnp.float32)
    c = (crop_center * shape_f).astype(jnp.int32)
    m = (crop_size * shape_f).astype(jnp.int32)
    lo = jnp.maximum(0, c - m // 2).astype(jnp.float32)
    hi = jnp.minimum(c + (m - m // 2),
                     jnp.asarray(shape, jnp.int32)).astype(jnp.float32)
    return jnp.stack([lo / shape_f, hi / shape_f], axis=-1)


def flip_crop_resize(vol: jax.Array, crop_center: jax.Array,
                     crop_size: jax.Array, flip_axis: jax.Array,
                     crop_gate: jax.Array, is_mask: bool,
                     align_corners: bool = True,
                     out_sizes: Optional[Tuple[int, ...]] = None) -> jax.Array:
    """Conditional per-axis flip THEN gated crop-and-resize, composed into
    ONE set of per-axis tap-matrix tensordots (the training augmentation's
    steps 3+4, ``models.py:70-76`` order).

    ``crop(flip(x))`` per axis is ``M @ (P x) = (M P) x`` with ``P`` the
    reversal permutation — i.e. the tap matrix with its columns reversed —
    and a disabled crop gate selects the identity matrix, so flips, the
    crop and both probability gates cost zero extra full-volume passes
    (the separate ``jnp.flip``+select formulation paid 9 volume passes for
    the flips alone).

    ``out_sizes`` (masks only): additionally compose a trailing torch
    'nearest' downscale (``resize_nearest`` semantics, index
    ``floor(i*in/out)``) into the SAME tap matrices by row-selection —
    ``R(Mx) = (R M)x`` with ``R`` a one-hot row selector, so the result is
    bitwise equal to ``resize_nearest(flip_crop_resize(x), out_sizes)``
    while the resample emits ``prod(out/in)``× fewer elements.  The train
    step uses this to produce its half-resolution mask labels directly
    (the model and losses only ever consume masks at dense-map resolution,
    ``med3d.py:386``)."""
    ndim = vol.ndim
    if out_sizes is not None and not is_mask:
        raise ValueError("out_sizes composition is nearest-only (masks): "
                         "row-selecting a linear tap matrix is not a linear "
                         "resize of the output")
    box01 = _crop_box01(vol.shape, crop_center, crop_size)
    out = vol.astype(jnp.float32)
    for axis in range(ndim):
        in_size = vol.shape[axis]
        t = _base_grid_1d(in_size)
        b0, b1 = box01[axis, 0], box01[axis, 1]
        norm = t * (b1 - b0) + (b0 + b1 - 1.0)
        if is_mask:
            coords = _unnormalize(norm, in_size, align_corners=False)
            m = _tap_matrix_nearest(coords, in_size)
        else:
            coords = _unnormalize(norm, in_size, align_corners)
            m = _tap_matrix_linear(coords, in_size)
        m = jnp.where(crop_gate, m, jnp.eye(in_size, dtype=jnp.float32))
        m = jnp.where(flip_axis[axis], m[:, ::-1], m)
        if out_sizes is not None and out_sizes[axis] != in_size:
            rows = np.minimum(
                np.floor(np.arange(out_sizes[axis], dtype=np.float64)
                         * (in_size / out_sizes[axis])).astype(np.int32),
                in_size - 1)
            m = m[rows]
        out = jnp.tensordot(out, m, axes=([axis], [1]),
                            precision=jax.lax.Precision.HIGHEST)
        out = jnp.moveaxis(out, -1, axis)
    return out.astype(vol.dtype)


def crop_and_resize(vol: jax.Array, crop_center: jax.Array, crop_size: jax.Array,
                    is_mask: bool, align_corners: bool = True,
                    via: str = "gather") -> jax.Array:
    """The reference ``CropAndResize`` on one (D,H,W) volume.

    ``crop_center``/``crop_size`` are per-axis fractions; the integer box
    arithmetic replicates ``spatial_transforms.py:170-181``:
      lo = max(0, int(c*s) - int(m*s)//2); hi = min(int(c*s) + (int(m*s) -
      int(m*s)//2), s); box01 = (lo, hi)/s
    Images sample bilinear with the caller's align_corners (True in the
    training pipeline, ``models.py:70-74``); masks sample nearest with
    align_corners=False (``spatial_transforms.py:196-197``).
    """
    box01 = _crop_box01(vol.shape, crop_center, crop_size)
    if is_mask:
        out = axis_aligned_grid_sample(vol.astype(jnp.float32), box01, vol.shape,
                                       mode="nearest", align_corners=False,
                                       via=via)
    else:
        out = axis_aligned_grid_sample(vol, box01, vol.shape, mode="bilinear",
                                       align_corners=align_corners, via=via)
    # reference casts back to the input dtype after sampling
    # (spatial_transforms.py:190)
    return out.astype(vol.dtype)


def grid_sample_3d(vol: jax.Array, grid: jax.Array, mode: str = "bilinear",
                   align_corners: bool = False) -> jax.Array:
    """General (non-separable) 3-D grid sample, zeros padding.

    ``vol``: (D, H, W[, C]); ``grid``: (Do, Ho, Wo, 3) normalized coords in
    torch order (x=W, y=H, z=D).  Provided for full ``functional.py:79-94``
    API coverage; the training pipeline uses the separable fast path above.
    """
    has_c = vol.ndim == 4
    if not has_c:
        vol = vol[..., None]
    D, H, W, C = vol.shape
    xs = _unnormalize(grid[..., 0], W, align_corners)
    ys = _unnormalize(grid[..., 1], H, align_corners)
    zs = _unnormalize(grid[..., 2], D, align_corners)

    def gather(zi, yi, xi):
        valid = ((zi >= 0) & (zi < D) & (yi >= 0) & (yi < H)
                 & (xi >= 0) & (xi < W))
        zi = jnp.clip(zi, 0, D - 1)
        yi = jnp.clip(yi, 0, H - 1)
        xi = jnp.clip(xi, 0, W - 1)
        vals = vol[zi, yi, xi]
        return vals * valid[..., None].astype(vol.dtype)

    if mode == "nearest":
        out = gather(jnp.round(zs).astype(jnp.int32),
                     jnp.round(ys).astype(jnp.int32),
                     jnp.round(xs).astype(jnp.int32))
    else:
        z0 = jnp.floor(zs).astype(jnp.int32)
        y0 = jnp.floor(ys).astype(jnp.int32)
        x0 = jnp.floor(xs).astype(jnp.int32)
        wz = (zs - z0)[..., None]
        wy = (ys - y0)[..., None]
        wx = (xs - x0)[..., None]
        out = jnp.zeros(grid.shape[:-1] + (C,), jnp.float32)
        for dz, wz_ in ((0, 1 - wz), (1, wz)):
            for dy, wy_ in ((0, 1 - wy), (1, wy)):
                for dx, wx_ in ((0, 1 - wx), (1, wx)):
                    out = out + gather(z0 + dz, y0 + dy, x0 + dx).astype(jnp.float32) * (wz_ * wy_ * wx_)
    return out if has_c else out[..., 0]

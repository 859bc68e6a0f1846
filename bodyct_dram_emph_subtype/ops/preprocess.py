"""Fused on-device preprocessing: raw int16 CT → model-ready tensor.

The reference preprocesses every sample on the CPU in dataloader workers
(HU window → standardize → in-plane resize + depth subsample,
``models.py:57-63``), which BASELINE.json identifies as the throughput
bottleneck to kill.  Here the whole chain is one jitted program over a
batch of *raw int16* volumes:

- volumes of varying original sizes ride in one static padded buffer with a
  per-sample ``in_sizes`` vector; only gather indices depend on it, so one
  compiled executable serves every scan;
- shipping int16 instead of preprocessed float32 also halves host→device
  transfer bytes;
- the emphysema masks are derived on device too (LAA-950 for training,
  −910 ess for inference — the reference's two thresholds,
  ``dataset.py:149`` vs ``dataset.py:79``);
- standardization statistics are masked to the valid (unpadded) extent and
  use the unbiased (ddof=1) estimator like torch ``Tensor.std()``.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from .resize import depth_linspace_indices, nearest_gather_1d

WINDOW = (-1150.0, -300.0)


def _valid_mask(shape, in_sizes):
    m = jnp.ones(shape, jnp.bool_)
    for axis in range(3):
        idx = jax.lax.broadcasted_iota(jnp.int32, shape, axis)
        m &= idx < in_sizes[axis]
    return m


def _interp_matrix_dynamic(pad_in: int, out_size: int, in_size,
                           align_corners: bool = True) -> jax.Array:
    """(pad_in, out) linear-interp matrix built on device from a *traced*
    true extent — lets the variable-size resize run as a matmul instead of
    a gather.

    Tap indices use EXACT integer floors and the weight is the exact
    rational remainder over the denominator (one f32 division) — the f32
    ``floor(i*scale)`` form drifted from the host's f64 tables at
    exact-integer crossings and in the low weight bits; this form agrees with the host within one ulp of w everywhere
    and on every index exactly."""
    in_i = jnp.asarray(in_size, jnp.int32)
    i = jnp.arange(out_size, dtype=jnp.int32)
    if align_corners:
        den = max(out_size - 1, 1)
        num = i * (in_i - 1)
        i0 = jnp.clip(num // den, 0, in_i - 1)
        w = (num - i0 * den).astype(jnp.float32) / float(den)
    else:
        # src = (i + 0.5) * in/out - 0.5 = (2i*in + in - out) / (2*out)
        den = 2 * out_size
        num = jnp.maximum(2 * i * in_i + in_i - out_size, 0)
        i0 = jnp.clip(num // den, 0, in_i - 1)
        w = (num - i0 * den).astype(jnp.float32) / float(den)
    i1 = jnp.minimum(i0 + 1, in_i - 1)
    # clamped taps (i0 == i1 == in-1): torch keeps the fractional w on a
    # duplicated tap — (1-w)+w on the same row sums to 1 either way
    rows = jnp.arange(pad_in, dtype=jnp.int32)[:, None]
    return ((rows == i0[None, :]) * (1.0 - w)[None, :]
            + (rows == i1[None, :]) * w[None, :])


def _resize_plane_hw(vol, in_sizes, h_new, w_new, is_mask: bool):
    if is_mask:
        # nearest resampling is dtype-exact: gather masks at 1 byte/voxel
        # (4x less memory traffic than the f32 form), cast after the crop
        assert vol.dtype == jnp.uint8, vol.dtype
        out = nearest_gather_1d(vol, h_new, -2, in_sizes[1])
        return nearest_gather_1d(out, w_new, -1, in_sizes[2])
    # matmul path: bilinear in-plane resize as two interp-matrix matmuls
    mh = _interp_matrix_dynamic(vol.shape[-2], h_new, in_sizes[1])
    mw = _interp_matrix_dynamic(vol.shape[-1], w_new, in_sizes[2])
    prec = (jax.lax.Precision.HIGHEST if vol.dtype == jnp.float32
            else None)
    out = jnp.tensordot(vol, mh, axes=([-2], [0]),
                        precision=prec)                # (D, W, Hn)
    return jnp.tensordot(out, mw, axes=([-2], [0]),
                         precision=prec)               # (D, Hn, Wn)


def preprocess_one(image_i16: jax.Array, lung: jax.Array,
                   in_sizes: jax.Array, target_size: Tuple[int, int, int],
                   em_threshold: float) -> Dict[str, jax.Array]:
    """One padded (Dp,Hp,Wp) int16 volume → model-ready dict.

    The depth subsample (nearest over linspace indices) runs FIRST: every
    per-plane op (window, normalize, em threshold, in-plane resize)
    commutes exactly with plane selection, so doing it up front cuts the
    per-voxel work and traffic by D_pad/D_out (~20-25%).  Only the
    standardization statistics read the full valid volume — and those are
    pure reductions the windowing fuses into (nothing full-size is ever
    materialized)."""
    d_new, h_new, w_new = target_size
    valid = _valid_mask(image_i16.shape, in_sizes)
    lo, hi = WINDOW
    # masked standardize stats over the FULL valid volume (torch
    # Tensor.std(), unbiased) — reductions only, fused with the window
    img_full = (jnp.clip(image_i16.astype(jnp.float32), lo, hi) - lo) \
        / (hi - lo)
    n = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 2.0)
    vf = valid.astype(jnp.float32)
    mean = jnp.sum(img_full * vf) / n
    var = jnp.sum((img_full - mean) ** 2 * vf) / (n - 1.0)

    idx = depth_linspace_indices(in_sizes[0], d_new)
    img_d = jnp.take(image_i16, idx, axis=0).astype(jnp.float32)
    lung_d = jnp.take(lung, idx, axis=0)
    # the taken depth planes are all valid by construction (idx <
    # in_sizes[0]); only H/W padding needs masking out of the em mask
    valid_hw = (
        (jax.lax.broadcasted_iota(jnp.int32, img_d.shape, 1) < in_sizes[1])
        & (jax.lax.broadcasted_iota(jnp.int32, img_d.shape, 2)
           < in_sizes[2]))
    em_d = (img_d < em_threshold) & (lung_d > 0) & valid_hw
    img = ((jnp.clip(img_d, lo, hi) - lo) / (hi - lo) - mean) \
        * jax.lax.rsqrt(var)
    out_img = _resize_plane_hw(img, in_sizes, h_new, w_new, is_mask=False)
    out_lung = _resize_plane_hw((lung_d > 0).astype(jnp.uint8), in_sizes,
                                h_new, w_new, is_mask=True)
    out_em = _resize_plane_hw(em_d.astype(jnp.uint8), in_sizes,
                              h_new, w_new, is_mask=True)
    return {"image": out_img, "lung_mask": out_lung.astype(jnp.float32),
            "em_mask": out_em.astype(jnp.float32)}


def preprocess_one_preselected(image_i16: jax.Array, lung_sel: jax.Array,
                               in_sizes: jax.Array, moments: jax.Array,
                               target_size: Tuple[int, int, int],
                               em_threshold: float) -> Dict[str, jax.Array]:
    """Host-preselected variant of :func:`preprocess_one`.

    The host already (a) took the exact linspace depth slices of the CT
    (``data/host_preprocess.py::depth_indices_np`` — the same rational
    floor as :func:`~.resize.depth_linspace_indices`, so the selection is
    bit-identical), (b) computed the standardize moments over the FULL
    valid volume from exact int64 sums
    (``data/host_preprocess.py::window_moments_np``), and (c) shipped the
    lung mask fully nearest-preselected to ``target_size`` (nearest
    resampling is a pure index selection, so the host table
    ``resize_nearest_np`` equals the device gather bit-for-bit).  The
    device therefore receives only ``target_size[0]`` CT depth planes and
    target-resolution lung bits — ~25% fewer host→device bytes at
    deployment pad shapes — and runs no full-volume reductions and no mask
    resizes.

    The em mask commutes with nearest selection: ``nearest(em)`` selects
    tap pixels, so ``em_out = (raw[tap] < thr) & lung[tap]`` — the raw
    taps are gathered here (the in-plane selection indices land inside the
    true extent by construction, so no validity mask is needed).

    ``image_i16``: (d_out, Hp, Wp) depth-selected planes;
    ``lung_sel``: (d_out, h_out, w_out) nearest-preselected lung;
    ``moments``: (2,) float32 ``[mean, inv_std]`` of the windowed volume;
    ``in_sizes[0]`` is ignored (depth is already target-sized)."""
    d_new, h_new, w_new = target_size
    assert image_i16.shape[0] == d_new, (image_i16.shape, target_size)
    assert lung_sel.shape == (d_new, h_new, w_new), lung_sel.shape
    lo, hi = WINDOW
    img = ((jnp.clip(image_i16.astype(jnp.float32), lo, hi) - lo)
           / (hi - lo) - moments[0]) * moments[1]
    out_img = _resize_plane_hw(img, in_sizes, h_new, w_new, is_mask=False)
    raw_tap = nearest_gather_1d(image_i16, h_new, -2, in_sizes[1])
    raw_tap = nearest_gather_1d(raw_tap, w_new, -1, in_sizes[2])
    out_em = (raw_tap.astype(jnp.float32) < em_threshold) & (lung_sel > 0)
    return {"image": out_img,
            "lung_mask": (lung_sel > 0).astype(jnp.float32),
            "em_mask": out_em.astype(jnp.float32)}


@functools.partial(jax.jit, static_argnames=("target_size", "em_threshold"))
def fused_preprocess_preselected(
        images_i16: jax.Array, lungs: jax.Array, in_sizes: jax.Array,
        moments: jax.Array,
        target_size: Tuple[int, int, int] = (128, 224, 288),
        em_threshold: float = -950.0) -> Dict[str, jax.Array]:
    """Batched :func:`preprocess_one_preselected`.

    ``images_i16``: (B, d_out, Hp, Wp); ``lungs``: (B, *target_size)
    nearest-preselected; ``moments``: (B, 2) float32."""
    fn = functools.partial(preprocess_one_preselected,
                           target_size=target_size,
                           em_threshold=em_threshold)
    return jax.vmap(fn)(images_i16, lungs, in_sizes, moments)


@functools.partial(jax.jit, static_argnames=("target_size", "em_threshold"))
def fused_preprocess(images_i16: jax.Array, lungs: jax.Array,
                     in_sizes: jax.Array,
                     target_size: Tuple[int, int, int] = (128, 224, 288),
                     em_threshold: float = -950.0) -> Dict[str, jax.Array]:
    """Batched fused preprocess.

    ``images_i16``: (B, Dp, Hp, Wp) int16 padded volumes;
    ``lungs``: (B, Dp, Hp, Wp) any integer/bool mask;
    ``in_sizes``: (B, 3) true extents.  ``em_threshold``: −950 (training
    LAA) or −910 (inference ess).
    """
    fn = functools.partial(preprocess_one, target_size=target_size,
                           em_threshold=em_threshold)
    return jax.vmap(fn)(images_i16, lungs, in_sizes)

"""NumPy mirror of the deterministic per-sample preprocess chain.

window(-1150,-300 → 0,1) → standardize → in-plane bilinear resize +
linspace depth subsample (reference ``models.py:57-63``), for the *host*
input-pipeline mode where loader threads deliver ready-to-stack fixed-shape
float32 volumes and the device runs only augmentation + model.

Numerics match the JAX/torch implementations (indices and weights computed
in float64, like torch CPU kernels); see ``ops/resize.py`` for the device
version and the parity tests.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _linear_taps(out_size: int, in_size: int, align_corners: bool):
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = (in_size - 1) / (out_size - 1) if out_size > 1 else 0.0
        src = i * scale
    else:
        src = np.maximum((i + 0.5) * in_size / out_size - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w = (src - i0).astype(np.float32)
    return i0, i1, w


def resize_linear_np(x: np.ndarray, out_sizes, axes, align_corners: bool
                     ) -> np.ndarray:
    x = x.astype(np.float32)
    for axis, out_size in zip(axes, out_sizes):
        i0, i1, w = _linear_taps(out_size, x.shape[axis], align_corners)
        shape = [1] * x.ndim
        shape[axis] = out_size
        w = w.reshape(shape)
        x = (np.take(x, i0, axis=axis) * (1 - w)
             + np.take(x, i1, axis=axis) * w)
    return x


def resize_linear_matmul_np(x: np.ndarray, out_sizes, axes,
                            align_corners: bool) -> np.ndarray:
    """Fast-ordered n-linear resize for the deployment host: per-axis
    two-tap gather + lerp, axes processed most-shrinking first (separable
    1-D linear operators commute, so only f32 rounding can differ).

    Equal to :func:`resize_linear_np` up to final-rounding/FMA
    differences (same float64-derived taps; the per-axis ORDER reassigns
    rounding ties by one ulp — and by one count after a uint8
    quantization).

    The two-tap chain does 2·out work per axis where a dense (in, out)
    interpolation GEMM does in·out."""
    x = x.astype(np.float32)
    order = sorted(zip(axes, out_sizes),
                   key=lambda p: p[1] / x.shape[p[0]])
    return np.ascontiguousarray(resize_linear_np(
        x, [s for _, s in order], [a for a, _ in order], align_corners))


def resize_nearest_np(x: np.ndarray, out_sizes, axes) -> np.ndarray:
    """torch 'nearest': floor(i * in/out) — as the EXACT integer rational
    floor, bit-identical to the device path (``ops/resize.py``) at every
    size (float floors flip at exact-integer crossings; the masks these
    indices select gate the lesion percentages)."""
    for axis, out_size in zip(axes, out_sizes):
        n = x.shape[axis]
        idx = np.minimum((np.arange(out_size, dtype=np.int64) * n)
                         // out_size, n - 1)
        x = np.take(x, idx, axis=axis)
    return x


def depth_indices_np(d_in: int, d_out: int) -> np.ndarray:
    """``torch.linspace(0, D-1, newD).long()`` as the exact rational floor
    (same rationale and bit-parity as :func:`resize_nearest_np`)."""
    if d_out > 1:
        return (np.arange(d_out, dtype=np.int64) * (d_in - 1)) // (d_out - 1)
    return np.zeros(1, np.int64)


def window_moments_np(img: np.ndarray,
                      window=(-1150.0, -300.0)) -> np.ndarray:
    """``[mean, 1/std]`` (float32) of the windowed volume from EXACT
    integer sums.

    The standardize statistics are the one part of the preprocess that
    reads the full volume, so the depth-preselected device pipeline
    (``ops/preprocess.py::preprocess_one_preselected``) ships them as two
    scalars instead of shipping every depth plane.  Sums are exact int64
    over the clipped int16 HU values; the mean/variance algebra then runs
    in arbitrary-precision Python ints with ONE float division each, so the
    result is the correctly-rounded f64 of the true rational value —
    strictly more accurate than both the torch-parity oracle's f32
    pairwise sums (``preprocess_sample``) and the on-device f32 reductions
    (``preprocess_one``), and within their ~1e-7 relative agreement.
    Unbiased (ddof=1) like torch ``Tensor.std()``."""
    lo_i, hi_i = int(window[0]), int(window[1])
    c = np.clip(np.asarray(img, np.int16), lo_i, hi_i).astype(np.int32)
    n = int(c.size)
    s1 = int(c.sum(dtype=np.int64))
    # c*c stays well inside int32 (|c| <= 2048 -> c*c <= 4.2e6)
    s2 = int((c * c).sum(dtype=np.int64))
    r = hi_i - lo_i
    mean = (s1 - n * lo_i) / (n * r)
    var_num = s2 * n - s1 * s1        # exact: n*(n-1)*var(c)... / n below
    var = var_num / (n * max(n - 1, 1) * r * r)
    inv_std = 1.0 / np.sqrt(var) if var > 0 else 0.0
    return np.asarray([mean, inv_std], np.float32)


def preprocess_sample(sample: Dict[str, np.ndarray],
                      target_size: Tuple[int, int, int],
                      window=(-1150.0, -300.0)) -> Dict[str, np.ndarray]:
    """window → standardize → interpolate on one archive sample; masks get
    nearest in-plane + the same depth subsampling."""
    out = dict(sample)
    img = np.asarray(sample["image"]).astype(np.float32)
    lo, hi = window
    img = np.clip(img, lo, hi)
    img = (img - lo) / (hi - lo)
    img = (img - img.mean()) / (img.std(ddof=1) + 0.0)
    d_new, h_new, w_new = target_size
    d_idx = depth_indices_np(img.shape[0], d_new)
    img = resize_linear_np(img, (h_new, w_new), (1, 2), align_corners=True)
    out["image"] = np.ascontiguousarray(img[d_idx])
    for key in sample:
        if "mask" in key:
            m = np.asarray(sample[key]).astype(np.float32)
            m = resize_nearest_np(m, (h_new, w_new), (1, 2))
            out[key] = np.ascontiguousarray(m[d_idx])
    return out


class PreprocessedView:
    """Dataset adapter: applies ``preprocess_sample`` on ``__getitem__`` —
    what the loader threads run in host-pipeline mode."""

    def __init__(self, dataset, target_size, window=(-1150.0, -300.0)):
        self.dataset = dataset
        self.target_size = tuple(target_size)
        self.window = window

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        return preprocess_sample(self.dataset[index], self.target_size,
                                 self.window)

    def __getattr__(self, name):
        return getattr(self.dataset, name)


class RawPaddedView:
    """Dataset adapter for the *device* input pipeline: loader threads only
    pad raw int16 volumes + lung masks into a static buffer; windowing,
    standardization, resizing, and the LAA mask all run fused on the device
    (``ops/preprocess.py``), so the host does no arithmetic at all."""

    def __init__(self, dataset, pad_shape):
        self.dataset = dataset
        self.pad_shape = tuple(pad_shape)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        d = self.dataset[index]
        img = np.asarray(d["image"])
        lung = np.asarray(d["lung_mask"])
        shape = img.shape
        if any(s > p for s, p in zip(shape, self.pad_shape)):
            raise ValueError(f"sample {index} shape {shape} exceeds "
                             f"pad_shape {self.pad_shape}")
        img_p = np.full(self.pad_shape, -2048, np.int16)
        lung_p = np.zeros(self.pad_shape, np.uint8)
        sl = tuple(slice(0, s) for s in shape)
        img_p[sl] = img.astype(np.int16)
        lung_p[sl] = (lung > 0)
        out = {"image_raw": img_p, "lung_raw": lung_p,
               "in_sizes": np.asarray(shape, np.int32)}
        for key in ("cls_label", "pse_label", "index"):
            if key in d:
                out[key] = d[key]
        return out

    def __getattr__(self, name):
        return getattr(self.dataset, name)

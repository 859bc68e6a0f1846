"""Building blocks for the 3-D ResNet zoo, NDHWC layout.

Structural parity targets in the reference ``med3d.py``:
- ``conv3x3x3``                  (``med3d.py:91-100``)
- ``downsample_basic_block``     (shortcut type 'A': stride-subsample +
                                  channel zero-pad, ``med3d.py:103-112``)
- ``BasicBlock`` (expansion 1)   (``med3d.py:115-144``)
- ``Bottleneck`` (expansion 4)   (``med3d.py:147-184``)
- ``crop_concat_5d``             (``med3d.py:39-48``)
- ``UpsampleConvBlock5d``        (``med3d.py:50-89``)
- ``normal_wrapper``/``act_wrapper`` (``med3d.py:10-37``)

Design notes:
- activations are NDHWC (channels-last) and kernels DHWIO;
- BatchNorm statistics are taken over (N, D, H, W); when the batch dim is
  sharded over the mesh's data axis under GSPMD jit the reduction becomes a
  global (cross-replica) mean — exactly the reference's
  ``sync_batchnorm=True`` semantics with zero extra code;
- dilated convolutions run through space-to-batch (:func:`dilated_conv3d`),
  exact and equal to ``rhs_dilation``.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .layers import (
    Module,
    Scope,
    batch_norm,
    group_norm,
    kaiming_normal_fan_out,
    max_pool_3d,
    module,
    relu,
    zeros,
)

Dtype = Any
_DN = ("NDHWC", "DHWIO", "NDHWC")


def _triple(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def conv3d(s: Scope, x, features: int, kernel, stride=1, dilation: int = 1,
           bias: bool = False, dtype=None):
    """3-D conv with torch-style symmetric padding, pad = d·(k−1)/2
    (``med3d.py:91-100``; ``padding=3`` for the k=7 stem).  Variables:
    ``kernel`` (DHWIO) and optional ``bias``."""
    kernel, stride = _triple(kernel), _triple(stride)
    k = s.param("kernel", kaiming_normal_fan_out,
                (*kernel, x.shape[-1], features))
    b = s.param("bias", zeros, (features,)) if bias else None
    dtype = dtype or x.dtype
    x, k = x.astype(dtype), k.astype(dtype)
    if dilation > 1:
        assert stride == (1, 1, 1), "dilated convs are stride-1 here"
        out = dilated_conv3d(x, k, dilation)
    else:
        out = jax.lax.conv_general_dilated(
            x, k, stride, [((n - 1) // 2, (n - 1) // 2) for n in kernel],
            dimension_numbers=_DN)
    if b is not None:
        out = out + b.astype(dtype)
    return out


def space_to_batch_3d(x, d: int):
    """(B, D, H, W, C) → (B·d³, D/d, H/d, W/d, C): the d³ interleaved
    sub-grids of a dilation-d conv, folded into the batch dim (batch-major,
    so a data-sharded batch stays shardable).  Requires d | D,H,W."""
    B, D, H, W, C = x.shape
    xs = x.reshape(B, D // d, d, H // d, d, W // d, d, C)
    xs = xs.transpose(0, 2, 4, 6, 1, 3, 5, 7)
    return xs.reshape(B * d * d * d, D // d, H // d, W // d, C)


def batch_to_space_3d(x, d: int):
    """Inverse of :func:`space_to_batch_3d`."""
    Bd, Dd, Hd, Wd, C = x.shape
    B = Bd // (d * d * d)
    xs = x.reshape(B, d, d, d, Dd, Hd, Wd, C)
    xs = xs.transpose(0, 4, 1, 5, 2, 6, 3, 7)
    return xs.reshape(B, Dd * d, Hd * d, Wd * d, C)


def dilated_conv3d(x, kernel, d: int):
    """Stride-1 dilation-d 3-D conv (pad d·(k−1)/2) via space-to-batch.

    out[x] = Σ_k w[k]·in[x + d·(k−1)] couples only voxels on the same
    residue class mod d per axis, so the conv decomposes into d³ independent
    dense convs over interleaved sub-grids, batched together.  Spatial dims
    are zero-padded up to multiples of d and the output cropped back —
    identical numerics to torch's ``Conv3d(dilation=d, padding=d)`` (the
    padded voxels read the same zeros the conv padding would)."""
    B, D, H, W, C = x.shape
    pads = [(-n) % d for n in (D, H, W)]
    if any(pads):
        x = jnp.pad(x, [(0, 0)] + [(0, p) for p in pads] + [(0, 0)])
    out = jax.lax.conv_general_dilated(
        space_to_batch_3d(x, d), kernel, (1, 1, 1),
        [((n - 1) // 2, (n - 1) // 2) for n in kernel.shape[:3]],
        dimension_numbers=_DN)
    out = batch_to_space_3d(out, d)
    return out[:, :D, :H, :W, :] if any(pads) else out


# ---------------------------------------------------------------------------
# k=7 stride-2 stem conv via space-to-depth
# ---------------------------------------------------------------------------

# s2d block factors for the stem conv.  (2,2,2) is the classic exact
# mapping; larger factors deepen the contraction (Cin 8 -> 32) at the cost
# of structurally-zero tap positions.  Each axis falls back to 2 when the
# input extent does not divide.
STEM_S2D_FACTORS = (2, 2, 8)


def _s2d_axis_extent(f: int):
    """Kernel extent + left offset on one s2d axis with block factor ``f``.

    Output j (0 <= j < f/2) tap k (0..6) reads raw offset r = 2j + k - 3
    relative to the block start: r in [-3, f+1], so the block-index range
    floor(r/f) is {-2..1} for f = 2 and {-1..1} for f >= 4."""
    return (4, 2) if f == 2 else (3, 1)


@functools.lru_cache(maxsize=8)
def _s2d_stem_map(factors=(2, 2, 2)) -> np.ndarray:
    """(343, S) 0/1 matrix mapping the logical 7^3 stem kernel onto a
    space-to-depth (Ed,Eh,Ew, fd*fh*fw, nj*F) kernel for block factors
    (fd, fh, fw).  The classic (2,2,2) case is the (4,4,4,8,F) mapping
    (logical tap k reads block offset floor((k-3)/2), parity (k-3) mod 2)."""
    fd, fh, fw = factors
    (ed, od), (eh, oh), (ew, ow) = map(_s2d_axis_extent, factors)
    nj = (fd // 2) * (fh // 2) * (fw // 2)
    m = np.zeros((343, ed, eh, ew, fd * fh * fw, nj), np.float32)
    for jd in range(fd // 2):
        for jh in range(fh // 2):
            for jw in range(fw // 2):
                jidx = (jd * (fh // 2) + jh) * (fw // 2) + jw
                for kd in range(7):
                    rd = 2 * jd + kd - 3
                    for kh in range(7):
                        rh = 2 * jh + kh - 3
                        for kw in range(7):
                            rw = 2 * jw + kw - 3
                            cin = ((rd % fd) * fh + rh % fh) * fw + rw % fw
                            m[(kd * 7 + kh) * 7 + kw,
                              rd // fd + od, rh // fh + oh, rw // fw + ow,
                              cin, jidx] = 1.0
    return m.reshape(343, -1)


def stem_conv_s2d(x, kernel, factors=STEM_S2D_FACTORS):
    """The k=7 stride-2 pad-3 stem conv via space-to-depth.

    A stride-2 conv on a 1-channel volume contracts over only 343·1 taps;
    packing f³ input voxels into channels turns it into a stride-1 conv on
    a volume of 1/(fd·fh·fw) the positions — numerically identical (the
    mapped kernel reads exactly the same taps; the asymmetric padding
    reproduces the logical pad-3 zeros).  Falls back to the direct conv for
    odd spatial dims or Cin > 1."""
    cin, features = kernel.shape[-2:]
    if cin != 1 or any(n % 2 for n in x.shape[1:4]):
        return jax.lax.conv_general_dilated(x, kernel, (2, 2, 2),
                                            [(3, 3)] * 3,
                                            dimension_numbers=_DN)
    b, d, h, w, _ = x.shape
    fd, fh, fw = (f if n % f == 0 else 2 for f, n in zip(factors, (d, h, w)))
    (ed, od), (eh, oh), (ew, ow) = map(_s2d_axis_extent, (fd, fh, fw))
    nj = (fd // 2) * (fh // 2) * (fw // 2)
    xg = x.reshape(b, d // fd, fd, h // fh, fh, w // fw, fw)
    xg = xg.transpose(0, 1, 3, 5, 2, 4, 6).reshape(
        b, d // fd, h // fh, w // fw, fd * fh * fw)
    m = jnp.asarray(_s2d_stem_map((fd, fh, fw)), kernel.dtype)
    kp = jnp.einsum("ks,ko->so", m, kernel.reshape(343, features)).reshape(
        ed, eh, ew, fd * fh * fw, nj * features)
    y = jax.lax.conv_general_dilated(
        xg, kp, (1, 1, 1),
        [(od, ed - 1 - od), (oh, eh - 1 - oh), (ow, ew - 1 - ow)],
        dimension_numbers=_DN)
    if nj == 1:
        return y
    y = y.reshape(b, d // fd, h // fh, w // fw,
                  fd // 2, fh // 2, fw // 2, features)
    return y.transpose(0, 1, 4, 2, 5, 3, 6, 7).reshape(
        b, d // 2, h // 2, w // 2, features)


def stem_conv(s: Scope, x, features: int, dtype=None):
    """The trunk's ``conv1``: k7 s2 p3, no bias, through
    :func:`stem_conv_s2d`."""
    k = s.param("kernel", kaiming_normal_fan_out,
                (7, 7, 7, x.shape[-1], features))
    dtype = dtype or x.dtype
    return stem_conv_s2d(x.astype(dtype), k.astype(dtype))


@module
class NormWrapper(Module):
    """Norm selector (reference ``normal_wrapper``, ``med3d.py:10-28``).

    'bn'    — BatchNorm with running stats (the only method the model zoo
              instantiates);
    'bnt'   — BatchNorm w/o running stats (batch stats always used);
    'bntna' — same, no affine;
    'ln'    — GroupNorm(1) (layer norm over C,D,H,W);
    'lnna'  — same, no affine;
    'in'    — GroupNorm(C) (instance norm).
    'sbn'   — alias of 'bn': under GSPMD jit the batch-stat reduction is
              already cross-replica (SyncBatchNorm semantics).
    """
    method: str = "bn"
    momentum: float = 0.9   # torch BatchNorm3d momentum=0.1
    epsilon: float = 1e-5
    dtype: Optional[Dtype] = None

    def __call__(self, s: Scope, x, train: bool):
        m = self.method
        if m in ("bn", "sbn", "bnt", "bntna"):
            return batch_norm(
                s.child("bn"), x, train, momentum=self.momentum,
                epsilon=self.epsilon, affine=m != "bntna",
                use_running_average=(not train) if m in ("bn", "sbn")
                else False, dtype=self.dtype)
        if m in ("ln", "lnna"):
            return group_norm(s.child("gn"), x, 1, epsilon=self.epsilon,
                              affine=m == "ln", dtype=self.dtype)
        if m == "in":
            return group_norm(s.child("gn"), x, x.shape[-1],
                              epsilon=self.epsilon, dtype=self.dtype)
        raise NotImplementedError(m)


def max_pool_3d_k3s2p1(x):
    """torch ``MaxPool3d(kernel_size=3, stride=2, padding=1)``
    (``med3d.py:206``) on NDHWC activations."""
    return max_pool_3d(x, 3, 2, 1)


def downsample_shortcut_a(x, planes: int, stride: int):
    """Shortcut type 'A' (``med3d.py:103-112``): ``avg_pool3d(k=1, stride)``
    == strided subsample, then zero-pad channels up to ``planes``."""
    if stride != 1:
        x = x[:, ::stride, ::stride, ::stride, :]
    pad_c = planes - x.shape[-1]
    if pad_c > 0:
        x = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad_c)])
    return x


def downsample_b(s: Scope, x, planes: int, stride: int, train: bool,
                 dtype=None):
    """Shortcut type 'B' (``med3d.py:250-260``): 1x1x1 conv (stride s, no
    bias) + BatchNorm on the residual branch.  Torch state-dict names
    ``downsample.0`` (conv) / ``downsample.1`` (BN) map to
    ``downsample/conv`` / ``downsample/norm`` here (``torch_import.py``)."""
    x = conv3d(s.child("conv"), x, planes, 1, stride, dtype=dtype)
    return NormWrapper(dtype=dtype)(s.child("norm"), x, train)


@module
class BasicBlock(Module):
    """Two 3x3x3 convs + identity shortcut (``med3d.py:115-144``)."""
    planes: int
    stride: int = 1
    dilation: int = 1
    use_downsample: bool = False
    dtype: Optional[Dtype] = None
    shortcut_type: str = "A"
    expansion = 1

    def __call__(self, s: Scope, x, train: bool):
        norm = NormWrapper(dtype=self.dtype)
        out = conv3d(s.child("conv1"), x, self.planes, 3, self.stride,
                     self.dilation, dtype=self.dtype)
        out = relu(norm(s.child("bn1"), out, train))
        out = conv3d(s.child("conv2"), out, self.planes, 3, 1, self.dilation,
                     dtype=self.dtype)
        out = norm(s.child("bn2"), out, train)
        return relu(out + _shortcut(self, s, x, self.planes, train))


@module
class Bottleneck(Module):
    """1-3-1 bottleneck, expansion 4 (``med3d.py:147-184``)."""
    planes: int
    stride: int = 1
    dilation: int = 1
    use_downsample: bool = False
    dtype: Optional[Dtype] = None
    shortcut_type: str = "A"
    expansion = 4

    def __call__(self, s: Scope, x, train: bool):
        norm = NormWrapper(dtype=self.dtype)
        out = conv3d(s.child("conv1"), x, self.planes, 1, dtype=self.dtype)
        out = relu(norm(s.child("bn1"), out, train))
        out = conv3d(s.child("conv2"), out, self.planes, 3, self.stride,
                     self.dilation, dtype=self.dtype)
        out = relu(norm(s.child("bn2"), out, train))
        out = conv3d(s.child("conv3"), out, self.planes * 4, 1,
                     dtype=self.dtype)
        out = norm(s.child("bn3"), out, train)
        return relu(out + _shortcut(self, s, x, self.planes * 4, train))


def _shortcut(block, s: Scope, x, planes: int, train: bool):
    if not block.use_downsample:
        return x
    if block.shortcut_type == "A":
        return downsample_shortcut_a(x, planes, block.stride)
    return downsample_b(s.child("downsample"), x, planes, block.stride,
                        train, dtype=block.dtype)


def crop_concat(t1, t2):
    """Center-crop ``t2`` spatially to ``t1`` and concat channels
    (``med3d.py:39-48``; offset = ceil((b-a)/2) per axis).  NDHWC."""
    slices = [slice(None)]
    for a, b in zip(t1.shape[1:4], t2.shape[1:4]):
        off = -((a - b) // 2)  # == ceil((b-a)/2)
        slices.append(slice(off, a + off))
    slices.append(slice(None))
    return jnp.concatenate([t1, t2[tuple(slices)]], axis=-1)


@module
class UpsampleConvBlock(Module):
    """Trilinear x2 upsample (align_corners=True) + crop-concat + N
    conv-BN-ReLU stages (``med3d.py:50-89``; the reference always calls it
    with dropout 0)."""
    base_chs: Sequence[int]
    scale_factor: int = 2
    conv_ksize: int = 3
    conv_bias: bool = True
    norm_method: str = "bn"
    dtype: Optional[Dtype] = None

    def __call__(self, s: Scope, inputs, cats, train: bool):
        from ..ops.resize import resize_linear_matmul
        d, h, w = inputs.shape[1:4]
        up = resize_linear_matmul(inputs, (d * self.scale_factor,
                                           h * self.scale_factor,
                                           w * self.scale_factor),
                                  (1, 2, 3), align_corners=True)
        x = crop_concat(up.astype(inputs.dtype), cats)
        norm = NormWrapper(self.norm_method, dtype=self.dtype)
        for idx, ch in enumerate(self.base_chs):
            x = conv3d(s.child(f"conv{idx}"), x, ch, self.conv_ksize,
                       bias=self.conv_bias, dtype=self.dtype)
            x = relu(norm(s.child(f"norm{idx}"), x, train))
        return x

"""Parity tests of resize ops vs torch (CPU) as the semantic oracle.

The reference's numerics are defined by torch's interpolate/grid_sample
conventions; torch (CPU build) is available in the dev image, so we check our
pure-JAX implementations byte-for-byte (within float tolerance) against it.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from bodyct_dram_emph_subtype.ops import (
    depth_linspace_indices,
    interpolate_volume,
    resize_linear,
    resize_nearest,
)


@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", [((37, 53), (224, 288)),
                                          ((224, 288), (64, 80)),
                                          ((5, 7), (5, 7))])
def test_bilinear_matches_torch(rng, align_corners, in_hw, out_hw):
    x = rng.randn(3, *in_hw).astype(np.float32)
    want = F.interpolate(torch.from_numpy(x)[None], size=out_hw,
                         mode="bilinear", align_corners=align_corners)[0].numpy()
    got = np.asarray(resize_linear(jnp.asarray(x), out_hw, (-2, -1), align_corners))
    # separable two-pass lerp vs torch's fused 2-D lerp differ by fp32
    # rounding only
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("align_corners", [True, False])
def test_trilinear_matches_torch(rng, align_corners):
    x = rng.randn(1, 1, 9, 11, 13).astype(np.float32)
    out = (17, 23, 29)
    want = F.interpolate(torch.from_numpy(x), size=out, mode="trilinear",
                         align_corners=align_corners).numpy()
    got = np.asarray(resize_linear(jnp.asarray(x), out, (-3, -2, -1), align_corners))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("in_hw,out_hw", [((37, 53), (224, 288)),
                                          ((224, 288), (64, 80)),
                                          ((8, 8), (3, 5))])
def test_nearest_matches_torch(rng, in_hw, out_hw):
    x = rng.randn(2, *in_hw).astype(np.float32)
    want = F.interpolate(torch.from_numpy(x)[None], size=out_hw,
                         mode="nearest")[0].numpy()
    got = np.asarray(resize_nearest(jnp.asarray(x), out_hw, (-2, -1)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d_in,d_out", [(163, 128), (128, 128), (97, 128), (5, 3)])
def test_depth_linspace_matches_torch(d_in, d_out):
    want = torch.linspace(0, d_in - 1, d_out).long().numpy()
    got = np.asarray(depth_linspace_indices(d_in, d_out))
    np.testing.assert_array_equal(got, want)


def _torch_interpolate_transform(vol, target_size, is_mask):
    """Oracle reimplementation of the reference Interpolate semantics
    (spatial_transforms.py:55-97) using torch primitives."""
    t = torch.from_numpy(vol)[None].float()
    if is_mask:
        t = F.interpolate(t, size=target_size[1:], mode="nearest")
    else:
        t = F.interpolate(t, size=target_size[1:], mode="bilinear",
                          align_corners=True)
    idx = torch.linspace(0, vol.shape[0] - 1, target_size[0]).long()
    return t[0, idx].numpy()


def test_interpolate_volume_image(rng):
    vol = (rng.randn(91, 111, 87) * 100).astype(np.float32)
    target = (64, 96, 112)
    want = _torch_interpolate_transform(vol, target, is_mask=False)
    got = np.asarray(interpolate_volume(jnp.asarray(vol), target, is_mask=False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(vol).max())


def test_interpolate_volume_mask(rng):
    vol = (rng.rand(91, 111, 87) > 0.5).astype(np.float32)
    target = (64, 96, 112)
    want = _torch_interpolate_transform(vol, target, is_mask=True)
    got = np.asarray(interpolate_volume(jnp.asarray(vol), target, is_mask=True))
    np.testing.assert_array_equal(got, want)


def test_dynamic_in_size_matches_static(rng):
    """The fused preprocess path passes traced in_sizes over padded buffers."""
    vol = rng.randn(40, 50, 60).astype(np.float32)
    padded = np.zeros((64, 96, 96), np.float32)
    padded[:40, :50, :60] = vol
    target = (32, 48, 56)
    want = np.asarray(interpolate_volume(jnp.asarray(vol), target, is_mask=False))
    got = np.asarray(interpolate_volume(jnp.asarray(padded), target,
                                        is_mask=False, in_sizes=(40, 50, 60)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
def test_matmul_resize_matches_gather(rng, align_corners):
    from bodyct_dram_emph_subtype.ops.resize import resize_linear_matmul
    x = rng.randn(2, 9, 11, 13, 4).astype(np.float32)
    out = (18, 22, 26)
    want = np.asarray(resize_linear(jnp.asarray(x), out, (1, 2, 3),
                                    align_corners))
    got = np.asarray(resize_linear_matmul(jnp.asarray(x), out, (1, 2, 3),
                                          align_corners))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("align_corners", [True, False])
def test_matmul_resize_transpose_adjoint(rng, align_corners):
    """<R d, x> == <d, R^T x>: the percentage-reduction identity used by
    the deployment predict program (inference/processor.py) and bench."""
    from bodyct_dram_emph_subtype.ops.resize import (
        resize_linear_matmul, resize_linear_matmul_transpose)
    d = rng.rand(2, 9, 11, 13, 1).astype(np.float32)
    x = (rng.rand(2, 18, 22, 26, 1) > 0.5).astype(np.float32)
    up = np.asarray(resize_linear_matmul(jnp.asarray(d), (18, 22, 26),
                                         (1, 2, 3), align_corners))
    want = (up * x).sum(axis=(1, 2, 3, 4))
    w = np.asarray(resize_linear_matmul_transpose(jnp.asarray(x), (9, 11, 13),
                                                  (1, 2, 3), align_corners))
    got = (d * w).sum(axis=(1, 2, 3, 4))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

"""Parity of ROI-align / crop-resize vs torch affine_grid + grid_sample."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from bodyct_dram_emph_subtype.ops import crop_and_resize, grid_sample_3d


def _torch_roi_align(vol, box01, mode, align_corners):
    """Oracle: the reference roi_align pipeline (functional.py:67-94):
    axis-flip affine matrix + affine_grid(default align_corners=False) +
    grid_sample."""
    ndim = vol.ndim
    bb = torch.as_tensor(box01, dtype=torch.float32)[None]  # (1, ndim, 2)
    bb = bb[:, list(range(ndim))[::-1], :]
    scaler = (bb[:, :, 1] - bb[:, :, 0]).unsqueeze(1) * torch.eye(ndim)[None]
    shift = (-1.0 + bb.sum(-1)).unsqueeze(-1)
    aff = torch.cat([scaler, shift], dim=-1)
    t = torch.from_numpy(vol)[None, None].float()
    grid = F.affine_grid(aff, (1, 1) + vol.shape)
    out = F.grid_sample(t, grid, mode=mode, padding_mode="zeros",
                        align_corners=align_corners)
    return out[0, 0].numpy()


def _box01_from_params(shape, center, size):
    lo, hi = [], []
    for c, s, m in zip(center, shape, size):
        start = max(0, int(c * s) - int(m * s) // 2)
        stop = min(int(c * s) + (int(m * s) - int(m * s) // 2), s)
        lo.append(start / s)
        hi.append(stop / s)
    return np.stack([lo, hi], axis=-1)


@pytest.mark.parametrize("center,size", [
    ((0.5, 0.5, 0.5), (1.0, 1.0, 1.0)),
    ((0.45, 0.55, 0.5), (0.95, 0.97, 1.0)),
    ((0.3, 0.7, 0.5), (0.5, 0.6, 0.8)),
])
def test_crop_resize_image_matches_torch(rng, center, size):
    vol = rng.randn(17, 23, 19).astype(np.float32)
    box01 = _box01_from_params(vol.shape, center, size)
    want = _torch_roi_align(vol, box01, "bilinear", align_corners=True)
    got = np.asarray(crop_and_resize(jnp.asarray(vol),
                                     jnp.asarray(center, jnp.float32),
                                     jnp.asarray(size, jnp.float32),
                                     is_mask=False, align_corners=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("center,size", [
    ((0.45, 0.55, 0.5), (0.95, 0.97, 1.0)),
    ((0.5, 0.5, 0.5), (0.99, 0.95, 0.96)),
])
def test_crop_resize_mask_matches_torch(rng, center, size):
    vol = (rng.rand(17, 23, 19) > 0.5).astype(np.float32)
    box01 = _box01_from_params(vol.shape, center, size)
    want = _torch_roi_align(vol, box01, "nearest", align_corners=False)
    got = np.asarray(crop_and_resize(jnp.asarray(vol),
                                     jnp.asarray(center, jnp.float32),
                                     jnp.asarray(size, jnp.float32),
                                     is_mask=True))
    assert (got != want).mean() < 0.02  # nearest ties may round differently
    np.testing.assert_array_equal(got.shape, want.shape)


def test_general_grid_sample_matches_torch(rng):
    vol = rng.randn(9, 11, 13).astype(np.float32)
    grid = rng.uniform(-1.2, 1.2, (5, 6, 7, 3)).astype(np.float32)
    want = F.grid_sample(torch.from_numpy(vol)[None, None],
                         torch.from_numpy(grid)[None],
                         mode="bilinear", padding_mode="zeros",
                         align_corners=False)[0, 0].numpy()
    got = np.asarray(grid_sample_3d(jnp.asarray(vol), jnp.asarray(grid),
                                    mode="bilinear", align_corners=False))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_crop_resize_matmul_path_matches_gather(rng):
    """The matmul tap-matrix path (via='matmul', the fused-augmentation hot
    path) must reproduce the gather/lerp path: images to float tolerance,
    masks exactly (one-hot rows select identical taps)."""
    vol = rng.randn(12, 18, 14).astype(np.float32)
    mask = (rng.rand(12, 18, 14) > 0.5).astype(np.float32)
    for center, size in (((0.47, 0.52, 0.5), (0.95, 0.98, 1.0)),
                         ((0.5, 0.45, 0.55), (0.96, 1.0, 0.95))):
        c = jnp.asarray(center, jnp.float32)
        s = jnp.asarray(size, jnp.float32)
        want = np.asarray(crop_and_resize(jnp.asarray(vol), c, s,
                                          is_mask=False))
        got = np.asarray(crop_and_resize(jnp.asarray(vol), c, s,
                                         is_mask=False, via="matmul"))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        want_m = np.asarray(crop_and_resize(jnp.asarray(mask), c, s,
                                            is_mask=True))
        got_m = np.asarray(crop_and_resize(jnp.asarray(mask), c, s,
                                           is_mask=True, via="matmul"))
        np.testing.assert_array_equal(got_m, want_m)


def test_flip_crop_resize_composes_exactly(rng):
    """flip_crop_resize (one tap-matrix resample — the augmentation's
    steps 3+4) must equal the sequential formulation: conditional
    jnp.flip per axis, then crop_and_resize gated by crop_gate.  Masks
    exactly, images to float tolerance, across all gate combinations."""
    from bodyct_dram_emph_subtype.ops.grid_sample import flip_crop_resize

    vol = rng.randn(10, 14, 12).astype(np.float32)
    mask = (rng.rand(10, 14, 12) > 0.5).astype(np.float32)
    center = jnp.asarray((0.47, 0.53, 0.5), jnp.float32)
    size = jnp.asarray((0.95, 1.0, 0.97), jnp.float32)
    for flips in ((0, 0, 0), (1, 0, 1), (0, 1, 0), (1, 1, 1)):
        for crop_gate in (False, True):
            fa = jnp.asarray(flips, bool)
            cg = jnp.asarray(crop_gate)

            def seq(v, is_mask):
                x = jnp.asarray(v)
                for ax in range(3):
                    x = jnp.where(fa[ax], jnp.flip(x, axis=ax), x)
                c = crop_and_resize(x, center, size, is_mask=is_mask)
                return jnp.where(cg, c, x)

            want = np.asarray(seq(vol, False))
            got = np.asarray(flip_crop_resize(jnp.asarray(vol), center, size,
                                              fa, cg, is_mask=False))
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=f"img {flips} {crop_gate}")
            want_m = np.asarray(seq(mask, True))
            got_m = np.asarray(flip_crop_resize(jnp.asarray(mask), center,
                                                size, fa, cg, is_mask=True))
            np.testing.assert_array_equal(got_m, want_m)


def test_flip_crop_resize_mask_out_sizes_composes_downscale(rng):
    """out_sizes folds a trailing torch-nearest downscale into the mask
    resample by tap-matrix row selection — must be BITWISE equal to
    resampling at full size then resize_nearest (the train step relies on
    this to emit half-res mask labels directly)."""
    from bodyct_dram_emph_subtype.ops.grid_sample import flip_crop_resize
    from bodyct_dram_emph_subtype.ops.resize import resize_nearest

    mask = (rng.rand(12, 16, 20) > 0.5).astype(np.float32)
    center = jnp.asarray((0.46, 0.54, 0.51), jnp.float32)
    size = jnp.asarray((0.96, 1.0, 0.98), jnp.float32)
    # divisible halving (the train case) and a non-divisible downscale
    for out_sizes in ((6, 8, 10), (5, 7, 9), (12, 8, 20)):
        for flips in ((0, 0, 0), (1, 0, 1)):
            for crop_gate in (False, True):
                fa = jnp.asarray(flips, bool)
                cg = jnp.asarray(crop_gate)
                full = flip_crop_resize(jnp.asarray(mask), center, size,
                                        fa, cg, is_mask=True)
                want = np.asarray(resize_nearest(full, out_sizes, (0, 1, 2)))
                got = np.asarray(flip_crop_resize(
                    jnp.asarray(mask), center, size, fa, cg, is_mask=True,
                    out_sizes=out_sizes))
                np.testing.assert_array_equal(
                    got, want, err_msg=f"{out_sizes} {flips} {crop_gate}")
    with pytest.raises(ValueError):
        flip_crop_resize(jnp.asarray(mask), center, size,
                         jnp.zeros(3, bool), jnp.asarray(True),
                         is_mask=False, out_sizes=(6, 8, 10))

"""Parity of intensity ops vs torch/scipy oracles."""
import numpy as np
import torch

import jax
import jax.numpy as jnp

from bodyct_dram_emph_subtype.ops import (
    binary_dilate,
    binary_dilate_np,
    box_cutout,
    contrast_stretching,
    find_crops_np,
    gaussian_smooth,
    intensity_window,
    mask_bbox,
    pad_bbox_mm,
    standardize,
)


def test_intensity_window(rng):
    x = rng.randint(-2048, 1000, (13, 17, 19)).astype(np.int16)
    xt = torch.from_numpy(x.astype(np.float32))
    want = (torch.clamp(xt, -1150, -300) - (-1150)) / 850.0
    got = np.asarray(intensity_window(jnp.asarray(x), (-1150, -300), (0, 1)))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-6)


def test_standardize_unbiased_std(rng):
    x = rng.randn(9, 11, 13).astype(np.float32) * 7 + 3
    xt = torch.from_numpy(x.copy())
    want = ((xt - xt.mean()) / xt.std()).numpy()  # unbiased std, torch default
    got = np.asarray(standardize(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_contrast_stretching(rng):
    x = rng.rand(6, 7, 8).astype(np.float32)
    want = 1.0 / (1.0 + (0.5 / (x + 1e-7)) ** 2.0)
    got = np.asarray(contrast_stretching(jnp.asarray(x), False, 0.5, 2.0))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_gaussian_smooth_matches_reference_algorithm(rng):
    """Oracle: the reference's permute-based separable 1-D conv
    (functional.py:54-64) reimplemented with torch."""
    x = rng.randn(7, 9, 11).astype(np.float32)
    sigma, truncate = 0.8, 4.0
    radius = int(truncate * sigma + 0.5)
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-0.5 / sigma ** 2 * xs ** 2)
    k = (k / k.sum()).view(1, 1, -1)
    img = torch.from_numpy(x.copy())
    for _ in range(img.dim()):
        img = torch.nn.functional.conv1d(
            img.reshape(-1, 1, img.shape[-1]), k, padding="same").view(*img.shape)
        img = img.permute(2, 0, 1).contiguous()
    want = img.numpy()
    got = np.asarray(gaussian_smooth(jnp.asarray(x), sigma, truncate))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_box_cutout_matches_reference_arithmetic(rng):
    x = rng.randn(16, 20, 24).astype(np.float32)
    centers = rng.uniform(0.2, 0.8, (3, 3)).astype(np.float32)
    sizes = rng.uniform(0.1, 0.3, (3, 3)).astype(np.float32)
    want = x.copy()
    for c, m in zip(centers[:2], sizes[:2]):  # only 2 of 3 valid
        sl = tuple(
            slice(max(0, int(mc * ds) - int(ms * ds) // 2),
                  min(int(mc * ds) + (int(ms * ds) - int(ms * ds) // 2), ds))
            for mc, ds, ms in zip(c, x.shape, m))
        want[sl] = 0.0
    valid = jnp.asarray([True, True, False])
    got = np.asarray(box_cutout(jnp.asarray(x), jnp.asarray(centers),
                                jnp.asarray(sizes), valid))
    np.testing.assert_array_equal(got, want)


def test_binary_dilate_matches_scipy(rng):
    from scipy import ndimage
    m = rng.rand(12, 14, 16) > 0.95
    want = ndimage.binary_dilation(
        m, ndimage.generate_binary_structure(3, 3), iterations=2)
    got = np.asarray(binary_dilate(jnp.asarray(m), 2))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(binary_dilate_np(m, 2), want)


def test_bbox_and_crops(rng):
    m = np.zeros((20, 30, 40), bool)
    m[3:9, 10:22, 5:31] = True
    bbox = np.asarray(mask_bbox(jnp.asarray(m)))
    np.testing.assert_array_equal(bbox, [[3, 9], [10, 22], [5, 31]])
    spacing = (2.0, 0.7, 0.7)
    slices = find_crops_np(m, spacing, border_mm=5)
    padded = np.asarray(pad_bbox_mm(jnp.asarray(bbox), m.shape, spacing, 5))
    for sl, (start, stop) in zip(slices, padded):
        assert sl.start == start and sl.stop == stop
    # scipy oracle
    from scipy import ndimage
    obj = ndimage.find_objects(m)[0]
    assert obj == tuple(slice(int(b[0]), int(b[1])) for b in bbox)

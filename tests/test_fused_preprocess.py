"""Fused on-device preprocess must match the host numpy chain exactly."""
import numpy as np

import jax.numpy as jnp

from bodyct_dram_emph_subtype.data.host_preprocess import preprocess_sample
from bodyct_dram_emph_subtype.ops.preprocess import fused_preprocess


def test_fused_matches_host_chain(rng):
    target = (16, 24, 32)
    pad_shape = (40, 48, 56)
    B = 3
    imgs = np.zeros((B, *pad_shape), np.int16)
    lungs = np.zeros((B, *pad_shape), np.int8)
    sizes = np.zeros((B, 3), np.int32)
    raw = []
    for b in range(B):
        shape = (40 - 4 * b, 48 - 6 * b, 56 - 8 * b)
        img = rng.randint(-1200, -400, shape).astype(np.int16)
        lung = (rng.rand(*shape) > 0.4).astype(np.int8)
        imgs[b, :shape[0], :shape[1], :shape[2]] = img
        lungs[b, :shape[0], :shape[1], :shape[2]] = lung
        sizes[b] = shape
        raw.append({"image": img, "lung_mask": lung,
                    "em_mask": (img < -950) & (lung > 0)})

    out = fused_preprocess(jnp.asarray(imgs), jnp.asarray(lungs),
                           jnp.asarray(sizes), target_size=target,
                           em_threshold=-950.0)
    for b in range(B):
        want = preprocess_sample(raw[b], target)
        np.testing.assert_allclose(np.asarray(out["image"][b]),
                                   want["image"], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(np.asarray(out["lung_mask"][b]),
                                      want["lung_mask"])
        np.testing.assert_array_equal(np.asarray(out["em_mask"][b]),
                                      want["em_mask"])


def test_preselected_matches_fused(rng):
    """The preselected transport variant (host takes the exact linspace
    depth slices, nearest-preselects the lung to target resolution, and
    ships exact-integer standardize moments) must reproduce the
    full-volume fused path: masks bit-exactly, image within f32
    moment-summation noise (the host moments are MORE accurate —
    ``window_moments_np``)."""
    from bodyct_dram_emph_subtype.data.host_preprocess import (
        depth_indices_np, resize_nearest_np, window_moments_np)
    from bodyct_dram_emph_subtype.ops.preprocess import \
        fused_preprocess_preselected

    target = (16, 24, 32)
    pad_shape = (40, 48, 56)
    B = 3
    imgs = np.zeros((B, *pad_shape), np.int16)
    lungs = np.zeros((B, *pad_shape), np.uint8)
    sizes = np.zeros((B, 3), np.int32)
    sel_imgs = np.zeros((B, target[0], *pad_shape[1:]), np.int16)
    sel_lungs = np.zeros((B, *target), np.uint8)
    moments = np.zeros((B, 2), np.float32)
    for b in range(B):
        shape = (40 - 4 * b, 48 - 6 * b, 56 - 8 * b)
        img = rng.randint(-1200, -400, shape).astype(np.int16)
        lung = (rng.rand(*shape) > 0.4).astype(np.uint8)
        imgs[b, :shape[0], :shape[1], :shape[2]] = img
        lungs[b, :shape[0], :shape[1], :shape[2]] = lung
        sizes[b] = shape
        idx = depth_indices_np(shape[0], target[0])
        sel_imgs[b] = imgs[b, idx]
        sel_lungs[b] = resize_nearest_np(lung[idx], target[1:], (1, 2))
        moments[b] = window_moments_np(img)

    ref = fused_preprocess(jnp.asarray(imgs), jnp.asarray(lungs),
                           jnp.asarray(sizes), target_size=target,
                           em_threshold=-910.0)
    got = fused_preprocess_preselected(
        jnp.asarray(sel_imgs), jnp.asarray(sel_lungs), jnp.asarray(sizes),
        jnp.asarray(moments), target_size=target, em_threshold=-910.0)
    np.testing.assert_array_equal(np.asarray(got["lung_mask"]),
                                  np.asarray(ref["lung_mask"]))
    np.testing.assert_array_equal(np.asarray(got["em_mask"]),
                                  np.asarray(ref["em_mask"]))
    np.testing.assert_allclose(np.asarray(got["image"]),
                               np.asarray(ref["image"]),
                               rtol=2e-5, atol=2e-5)


def test_window_moments_match_oracle(rng):
    """Exact-integer moments agree with the torch-parity oracle's f32
    mean/std to f32 summation noise."""
    from bodyct_dram_emph_subtype.data.host_preprocess import \
        window_moments_np

    img = rng.randint(-1300, -350, (37, 41, 53)).astype(np.int16)
    w = (np.clip(img.astype(np.float32), -1150, -300) + 1150) / 850.0
    mean, inv_std = window_moments_np(img)
    np.testing.assert_allclose(mean, w.mean(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(inv_std, 1.0 / w.std(ddof=1),
                               rtol=1e-5, atol=0)


def test_fused_preprocess_ess_threshold(rng):
    """-910 (inference) vs -950 (training) thresholds differ."""
    shape = (16, 20, 24)
    img = rng.randint(-1000, -860, shape).astype(np.int16)
    lung = np.ones(shape, np.int8)
    sizes = jnp.asarray([[*shape]], jnp.int32)
    out950 = fused_preprocess(jnp.asarray(img[None]), jnp.asarray(lung[None]),
                              sizes, target_size=shape, em_threshold=-950.0)
    out910 = fused_preprocess(jnp.asarray(img[None]), jnp.asarray(lung[None]),
                              sizes, target_size=shape, em_threshold=-910.0)
    assert (np.asarray(out910["em_mask"]).sum()
            > np.asarray(out950["em_mask"]).sum())

"""Fused on-device batched augmentation tests."""
import numpy as np

import jax
import jax.numpy as jnp

from bodyct_dram_emph_subtype.transforms import batch_augment
from bodyct_dram_emph_subtype.transforms.batch_augment import \
    set_noise_rng


def _batch(rng, b=4, shape=(16, 24, 32)):
    img = rng.randn(b, *shape).astype(np.float32)
    lung = (rng.rand(b, *shape) > 0.4).astype(np.float32)
    em = (rng.rand(b, *shape) > 0.8).astype(np.float32)
    return jnp.asarray(img), jnp.asarray(lung), jnp.asarray(em)


def test_shapes_preserved_and_deterministic(rng):
    img, lung, em = _batch(rng)
    out1 = batch_augment(img, lung, em, jax.random.PRNGKey(0))
    out2 = batch_augment(img, lung, em, jax.random.PRNGKey(0))
    for k in ("image", "lung_mask", "em_mask"):
        assert out1[k].shape == img.shape
        np.testing.assert_array_equal(np.asarray(out1[k]), np.asarray(out2[k]))


def test_varies_with_key_and_across_samples(rng):
    img, lung, em = _batch(rng)
    a = batch_augment(img, lung, em, jax.random.PRNGKey(0))
    b = batch_augment(img, lung, em, jax.random.PRNGKey(1))
    assert not np.allclose(np.asarray(a["image"]), np.asarray(b["image"]))
    # identical input samples must get *different* augmentations (per-sample
    # key split)
    same = jnp.broadcast_to(img[:1], img.shape)
    out = batch_augment(same, lung, em, jax.random.PRNGKey(2))
    assert not np.allclose(np.asarray(out["image"][0]),
                           np.asarray(out["image"][1]))


def test_rbg_noise_mode(rng):
    """'rbg' swaps only the noise epsilon source: the geometric stream
    (gates/cutout/flip/crop draws) is identical, so the mask outputs match
    the threefry run bit-for-bit and only the image may differ."""
    img, lung, em = _batch(rng)
    key = jax.random.PRNGKey(4)
    base = batch_augment(img, lung, em, key)
    set_noise_rng("rbg")
    try:
        out1 = batch_augment(img, lung, em, key)
        out2 = batch_augment(img, lung, em, key)
        for k in ("lung_mask", "em_mask"):
            np.testing.assert_array_equal(np.asarray(out1[k]),
                                          np.asarray(base[k]))
        np.testing.assert_array_equal(np.asarray(out1["image"]),
                                      np.asarray(out2["image"]))
        assert np.isfinite(np.asarray(out1["image"])).all()
        # noise magnitude stays in the reference's sigma band: in rescaled
        # [0,1] space the per-sample delta std is <= ~0.06 (plus clipping)
        scale = (np.asarray(img).max(axis=(1, 2, 3))
                 - np.asarray(img).min(axis=(1, 2, 3)))
        delta = (np.asarray(out1["image"]) - np.asarray(base["image"]))
        rel = np.abs(delta) / scale[:, None, None, None]
        assert rel.max() < 1.0
    finally:
        set_noise_rng("threefry")


def test_masks_stay_binary(rng):
    img, lung, em = _batch(rng)
    out = batch_augment(img, lung, em, jax.random.PRNGKey(3))
    for k in ("lung_mask", "em_mask"):
        vals = np.unique(np.asarray(out[k]))
        assert np.isin(vals, [0.0, 1.0]).all()

"""Fused on-device batched training augmentation.

The reference runs its four random augmentations per sample in CPU dataloader
workers (``models.py:64-76``): GaussianAdditive(p=.5) → BoxMaskOut(p=.5,
1–10 boxes) → Flip(p=.5, 1–2 axes) → CropAndResize(p=.5, center U(.45,.55),
size U(.95,1)).  That CPU chain is the training-throughput bottleneck.

Here the whole chain is a single jitted function over the *batch*, vmapped
with per-sample PRNG keys: every op is shape-static, the probability gates
become ``jnp.where`` selects (both branches are cheap elementwise/gather
work), and XLA fuses the chain into a handful of kernels that run on the
accelerator between host load and the forward pass.

Sampling distributions match the reference exactly; the RNG stream obviously
differs (JAX threefry vs python/numpy global state).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.grid_sample import flip_crop_resize
from ..ops.intensity import box_cutout, gaussian_additive_noise

MAX_CUTOUT_BOXES = 10

# Noise-epsilon RNG: 'threefry' draws per-sample inside the vmap (the JAX
# default — counter-based, stream-stable across platforms and versions);
# 'rbg' hoists ONE RngBitGenerator draw for the whole batch (its stream is
# NOT guaranteed stable across backends/compiler versions, which is
# irrelevant for augmentation noise).  Read at TRACE time: build train
# steps after setting it.
_NOISE_RNG = "threefry"


def set_noise_rng(impl: str) -> None:
    global _NOISE_RNG
    assert impl in ("threefry", "rbg"), impl
    _NOISE_RNG = impl


def get_noise_rng() -> str:
    return _NOISE_RNG


def batch_noise_eps(key: jax.Array, shape,
                    impl: Optional[str] = None) -> Optional[jax.Array]:
    """The hoisted batch-wide N(0,1) draw for 'rbg' mode (None otherwise).

    Derives the generator seed from the SAME batch key the per-sample
    chain splits, so a given (key, impl) pair is reproducible."""
    if (impl or _NOISE_RNG) != "rbg":
        return None
    seed = jax.random.bits(jax.random.fold_in(key, 0x6eb5), (4,), jnp.uint32)
    rk = jax.random.wrap_key_data(seed, impl="rbg")
    return jax.random.normal(rk, shape, jnp.float32)


def _augment_one(image: jax.Array, masks: Tuple[jax.Array, ...],
                 key: jax.Array, mask_out_size=None, noise_eps=None
                 ) -> Tuple[jax.Array, Tuple[jax.Array, ...]]:
    """Apply the training augmentation chain to one (D,H,W) sample.

    ``mask_out_size``: optional (D',H',W') — emit the masks directly at
    that resolution by composing the trailing torch-nearest downscale into
    the flip/crop tap matrices (bitwise equal to resampling at full size
    and then ``resize_nearest``-ing; see ``flip_crop_resize``).
    ``noise_eps``: optional pre-drawn N(0,1) field (``batch_noise_eps``)
    replacing the in-vmap threefry draw."""
    k_gate, k_noise, k_cut, k_flip, k_crop = jax.random.split(key, 5)
    gates = jax.random.uniform(k_gate, (4,)) < 0.5
    ndim = image.ndim

    # 1. additive gaussian noise in rescaled [0,1] space ------------------
    k_sigma, k_eps = jax.random.split(k_noise)
    sigma = jax.random.uniform(k_sigma, (), minval=0.03, maxval=0.06)
    noisy = gaussian_additive_noise(image, k_eps, sigma, eps=noise_eps)
    image = jnp.where(gates[0], noisy, image)

    # 2. box cutout -------------------------------------------------------
    k_n, k_c, k_s = jax.random.split(k_cut, 3)
    n_boxes = jax.random.randint(k_n, (), 1, MAX_CUTOUT_BOXES + 1)
    centers = jax.random.uniform(k_c, (MAX_CUTOUT_BOXES, ndim),
                                 minval=0.2, maxval=0.8)
    sizes = jax.random.uniform(k_s, (MAX_CUTOUT_BOXES, ndim),
                               minval=0.01, maxval=0.06)
    valid = (jnp.arange(MAX_CUTOUT_BOXES) < n_boxes) & gates[1]
    image = box_cutout(image, centers, sizes, valid)

    # 3+4. flip 1-2 random axes (dim=(1,3) quirk: randint(1,3) axes), then
    # crop-and-resize — composed into per-axis tap-matrix tensordots
    # (flip = reversed matrix columns, disabled crop = identity matrix),
    # so both stages and their probability gates cost ONE resample instead
    # of 9 flip passes + a gather crop + selects
    k_na, k_perm = jax.random.split(k_flip)
    n_axes = jax.random.randint(k_na, (), 1, 3)
    perm = jax.random.permutation(k_perm, ndim)
    inv_rank = jnp.argsort(perm)
    flip_axis = (inv_rank < n_axes) & gates[2]

    k_cc, k_cs = jax.random.split(k_crop)
    center = jax.random.uniform(k_cc, (ndim,), minval=0.45, maxval=0.55)
    size = jax.random.uniform(k_cs, (ndim,), minval=0.95, maxval=1.0)
    image = flip_crop_resize(image, center, size, flip_axis, gates[3],
                             is_mask=False, align_corners=True)
    masks = tuple(
        flip_crop_resize(m.astype(jnp.float32), center, size, flip_axis,
                         gates[3], is_mask=True, out_sizes=mask_out_size)
        for m in masks)
    return image, masks


@functools.partial(jax.jit, static_argnames=("mask_out_size", "noise_rng"))
def _batch_augment_impl(images, lung_masks, em_masks, key,
                        mask_out_size=None, noise_rng="threefry"):
    keys = jax.random.split(key, images.shape[0])
    eps = batch_noise_eps(key, images.shape, noise_rng)

    def one(img, lung, em, k, e):
        img, (lung, em) = _augment_one(img, (lung, em), k, mask_out_size, e)
        return img, lung, em

    img, lung, em = jax.vmap(one)(images,
                                  lung_masks.astype(jnp.float32),
                                  em_masks.astype(jnp.float32), keys, eps)
    return {"image": img, "lung_mask": lung, "em_mask": em}


def batch_augment(images: jax.Array, lung_masks: jax.Array,
                  em_masks: jax.Array, key: jax.Array,
                  mask_out_size=None) -> Dict[str, jax.Array]:
    """Vmapped augmentation over a (B, D, H, W) batch with per-sample keys."""
    return _batch_augment_impl(images, lung_masks, em_masks, key,
                               mask_out_size, get_noise_rng())

"""Jitted train / eval / predict steps for both training strategies.

These are the compute hearts of ``ScanCLSLightningModule`` /
``ScanRegLightningModule`` (reference ``models.py:160-698``), flattened into
pure functions:

- training: fused on-device augmentation → forward (cross-replica BN) →
  losses → grads → Adam update, one jit;
- the REG loss is ``cle + pse + 2*mutex_dice + coverage_bce``
  (``models.py:574``) with interval-regression sum reduction; the sum is
  divided by the mesh data-axis size so multi-chip gradients equal the
  reference's DDP grad-mean of per-rank sums;
- eval: forward + predicted labels;
- predict: forward + dRAM maps trilinearly upsampled (align_corners=True)
  to input size, masked by the −910 emphysema-susceptible mask, reduced to
  per-sample lesion percentages (``models.py:430-450``).  The reference
  normalises by the *whole batch's* lung volume (``models.py:440-441``),
  which is only correct at batch size 1; the default here is per-sample
  normalisation (identical at the deployment batch of one scan), with a
  ``batch_lung_norm=True`` strict-parity mode for bit-comparable
  validation at batch > 1.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..data.datasets import CLE_RATIO_MAP, PSE_RATIO_MAP
from ..losses import (
    generate_regression_labels,
    interval_regression_loss,
    ratio_to_label_batch,
    segmentation_losses,
    weighted_cross_entropy,
)
from ..ops.resize import resize_linear_matmul, resize_nearest
from ..transforms.batch_augment import _augment_one, batch_noise_eps
from .state import TrainState, apply_updates, make_optimizer


def _augment_batch(images, lungs, ems, key, mask_out_size=None):
    keys = jax.random.split(key, images.shape[0])
    eps = batch_noise_eps(key, images.shape)   # None unless noise rng 'rbg'

    def one(img, lung, em, k, e):
        img, (lung, em) = _augment_one(img, (lung, em), k, mask_out_size, e)
        return img, lung, em

    return jax.vmap(one)(images, lungs.astype(jnp.float32),
                         ems.astype(jnp.float32), keys, eps)


@functools.lru_cache(maxsize=32)
def _dense_map_size(model, spatial_shape):
    """Static (D',H',W') of the model's dense maps for a given input
    spatial shape (abstract eval, no FLOPs — safe to call at trace time).

    The train losses and the lung-masked pooling only ever consume the
    masks at this resolution (``med3d.py:386``), so the augmentation can
    emit them there directly (see ``flip_crop_resize`` out_sizes)."""
    x = jax.ShapeDtypeStruct((1, *spatial_shape, 1), jnp.float32)

    def fwd(x):
        v = model.init(jax.random.PRNGKey(0), x, x, train=False)
        dense, _ = model.apply(v, x, x, train=False)
        return dense[0]

    try:
        return tuple(jax.eval_shape(fwd, x).shape[1:4])
    except Exception:  # pragma: no cover — exotic model: keep full res
        return None


def _forward_train(model, state: TrainState, x, lungs):
    (dense, heads), mutated = model.apply(
        state.variables, x, lungs, train=True, mutable=["batch_stats"])
    return dense, heads, mutated["batch_stats"]


def _nchw_to_ndhwc(vol):
    """(B,D,H,W) → (B,D,H,W,1) model layout."""
    return vol[..., None]


def _batch_inputs(batch, fused_input, target_size):
    """Extract (images, lungs, ems) — either host-preprocessed arrays or,
    in the device input pipeline, raw padded int16 volumes run through the
    fused on-device preprocess (window/standardize/resize + LAA-950 mask)."""
    if fused_input:
        from ..ops.preprocess import fused_preprocess
        pre = fused_preprocess(batch["image_raw"], batch["lung_raw"],
                               batch["in_sizes"], target_size=target_size,
                               em_threshold=-950.0)
        return pre["image"], pre["lung_mask"], pre["em_mask"]
    # eval batches carry no em_mask (only the train losses need it)
    return batch["image"], batch["lung_mask"], batch.get("em_mask")


def make_reg_train_step(model, tx=None, num_data_shards: int = 1,
                        augment: bool = True, fused_input: bool = False,
                        target_size=(128, 224, 288), donate: bool = False,
                        accum_steps: int = 1):
    """dRAM (regression) training step (``models.py:539-592`` TRAIN branch).

    ``donate=True`` donates the incoming ``state`` buffers to the update
    (params + opt state alias in place, saving one full copy of both in
    HBM) — only safe when the caller overwrites its reference, i.e. the
    ``state = step(state, ...)`` pattern of the training loop.

    ``accum_steps > 1``: gradient accumulation — the batch splits into
    ``accum_steps`` microbatches run sequentially inside ONE jit via
    ``lax.scan`` (grads averaged, a single Adam update).  This scales the
    effective batch past what fits in device memory with the program size
    of one microbatch (the reference scales batch freely, ``train.py:42``).
    Semantics: standard grad accumulation —
    each microbatch's forward normalizes with its OWN batch statistics
    (== DDP across ``accum_steps`` more ranks with per-rank BN), running
    stats chain through the scan; grad-mean over microbatches of the
    per-microbatch sum losses == the reference's DDP grad-mean at world
    size ``accum_steps * num_data_shards``.
    """
    tx = tx or make_optimizer()

    def _micro_grads(state: TrainState, batch, lr, cle_class_weights,
                     pse_class_weights, key):
        """Grads + metrics/preds for one (micro)batch at fixed params."""
        images, lungs, ems = _batch_inputs(batch, fused_input, target_size)
        if augment:
            # masks are only ever consumed at dense-map resolution (masked
            # pooling + seg labels), so the augmentation emits them there
            # directly — bitwise equal to full-res resampling +
            # resize_nearest, 8x less resample work (shape is static at
            # trace time, so this composes per compiled input size)
            mask_out = _dense_map_size(model, tuple(images.shape[1:4]))
            if mask_out is not None and any(
                    o > i for o, i in zip(mask_out, images.shape[1:4])):
                mask_out = None  # never upsample masks early
            images, lungs, ems = _augment_batch(images, lungs, ems, key,
                                                mask_out)
        x = _nchw_to_ndhwc(images)
        lungs5 = _nchw_to_ndhwc(lungs.astype(jnp.float32))
        ems5 = _nchw_to_ndhwc(ems.astype(jnp.float32))
        cle_labels = batch["cls_label"].astype(jnp.int32)
        pse_labels = batch["pse_label"].astype(jnp.int32)
        cle_bands = generate_regression_labels(cle_labels, CLE_RATIO_MAP)
        pse_bands = generate_regression_labels(pse_labels, PSE_RATIO_MAP)
        w_cle = cle_class_weights[cle_labels]
        w_pse = pse_class_weights[pse_labels]

        def loss_fn(params):
            st = state.replace(params=params)
            dense, regs, new_stats = _forward_train(model, st, x, lungs5)
            loss_cle = interval_regression_loss(regs[0], cle_bands, w_cle)
            loss_pse = interval_regression_loss(regs[1], pse_bands, w_pse)
            binary = jnp.logical_or(cle_labels > 0, pse_labels > 0)
            seg_labels = resize_nearest(
                ems5 * binary[:, None, None, None, None].astype(jnp.float32),
                dense[0].shape[1:4], (1, 2, 3))
            lung_labels = resize_nearest(lungs5, dense[0].shape[1:4], (1, 2, 3))
            mul_loss, seg_loss = segmentation_losses(
                dense[0], dense[1], seg_labels, lung_labels)
            # DDP-equivalence over the mesh data axis: sum-reduced interval
            # losses divide by the shard count (grad-mean of per-rank sums);
            # the ratio-valued mutex/coverage terms are already global-batch
            # ratios (== the mean of per-rank ratios at shard level)
            loss = ((loss_cle + loss_pse) / num_data_shards
                    + 2.0 * mul_loss + seg_loss)
            aux = {"loss": loss, "loss_cle": loss_cle, "loss_pse": loss_pse,
                   "mul_loss": mul_loss, "seg_loss": seg_loss,
                   "regs": regs, "batch_stats": new_stats}
            return loss, aux

        grads, aux = jax.grad(loss_fn, has_aux=True)(state.params)
        preds = {
            "pred_cle_labels": ratio_to_label_batch(aux["regs"][0], CLE_RATIO_MAP),
            "pred_pse_labels": ratio_to_label_batch(aux["regs"][1], PSE_RATIO_MAP),
            "cle_labels": cle_labels, "pse_labels": pse_labels,
        }
        metrics = {k: aux[k] for k in
                   ("loss", "loss_cle", "loss_pse", "mul_loss", "seg_loss")}
        return grads, aux["batch_stats"], metrics, preds

    @functools.partial(jax.jit, donate_argnums=(0,) if donate else ())
    def step(state: TrainState, batch: Dict[str, jax.Array], lr,
             cle_class_weights, pse_class_weights, key):
        grads, new_stats, metrics, preds = _micro_grads(
            state, batch, lr, cle_class_weights, pse_class_weights, key)
        new_state = apply_updates(state, grads, tx, lr)
        new_state = new_state.replace(batch_stats=new_stats)
        return new_state, metrics, preds

    @functools.partial(jax.jit, donate_argnums=(0,) if donate else ())
    def step_accum(state: TrainState, batch: Dict[str, jax.Array], lr,
                   cle_class_weights, pse_class_weights, key):
        b = batch["cls_label"].shape[0]
        assert b % accum_steps == 0, (b, accum_steps)
        micro = {k: v.reshape(accum_steps, b // accum_steps, *v.shape[1:])
                 for k, v in batch.items()}
        keys = jax.random.split(key, accum_steps)

        def body(carry, mb_and_key):
            st, gsum = carry
            mb, k = mb_and_key
            grads, stats, metrics, preds = _micro_grads(
                st, mb, lr, cle_class_weights, pse_class_weights, k)
            gsum = jax.tree.map(jnp.add, gsum, grads)
            return (st.replace(batch_stats=stats), gsum), (metrics, preds)

        gzero = jax.tree.map(jnp.zeros_like, state.params)
        (st, gsum), (metrics_s, preds_s) = jax.lax.scan(
            body, (state, gzero), (micro, keys))
        grads = jax.tree.map(lambda g: g / accum_steps, gsum)
        new_state = apply_updates(
            state.replace(batch_stats=st.batch_stats), grads, tx, lr)
        metrics = jax.tree.map(jnp.mean, metrics_s)
        preds = jax.tree.map(lambda p: p.reshape(b, *p.shape[2:]), preds_s)
        return new_state, metrics, preds

    return step_accum if accum_steps > 1 else step


def make_cls_train_step(model, tx=None, num_data_shards: int = 1,
                        augment: bool = True, fused_input: bool = False,
                        target_size=(128, 224, 288), donate: bool = False,
                        accum_steps: int = 1):
    """Classification training step (``models.py:236-264`` TRAIN branch):
    weighted CE on pooled CLE+PSE logits.

    Multi-chip note: the reference's DDP averages per-rank weighted means;
    we compute the global-batch weighted mean (identical at world size 1 and
    the unbiased estimator in general).  ``donate`` and ``accum_steps``
    as in :func:`make_reg_train_step` — the reference scales the CLS batch
    freely on GPU (``train.py:42``); accumulation is how the effective
    batch scales past what fits in device memory here too."""
    tx = tx or make_optimizer()

    def _micro_grads(state: TrainState, batch, lr, cle_class_weights,
                     pse_class_weights, key):
        images, lungs, ems = _batch_inputs(batch, fused_input, target_size)
        if augment:
            images, lungs, ems = _augment_batch(images, lungs, ems, key)
        x = _nchw_to_ndhwc(images)
        lungs5 = _nchw_to_ndhwc(lungs.astype(jnp.float32))
        cle_labels = batch["cls_label"].astype(jnp.int32)
        pse_labels = batch["pse_label"].astype(jnp.int32)

        def loss_fn(params):
            st = state.replace(params=params)
            dense, logits, new_stats = _forward_train(model, st, x, lungs5)
            loss_cle = weighted_cross_entropy(logits[0], cle_labels,
                                              cle_class_weights)
            loss_pse = weighted_cross_entropy(logits[1], pse_labels,
                                              pse_class_weights)
            loss = loss_cle + loss_pse
            return loss, {"loss": loss, "loss_cle": loss_cle,
                          "loss_pse": loss_pse, "logits": logits,
                          "batch_stats": new_stats}

        grads, aux = jax.grad(loss_fn, has_aux=True)(state.params)
        preds = {
            "pred_cle_labels": jnp.argmax(aux["logits"][0], -1),
            "pred_pse_labels": jnp.argmax(aux["logits"][1], -1),
            "cle_labels": cle_labels, "pse_labels": pse_labels,
        }
        metrics = {k: aux[k] for k in ("loss", "loss_cle", "loss_pse")}
        return grads, aux["batch_stats"], metrics, preds

    @functools.partial(jax.jit, donate_argnums=(0,) if donate else ())
    def step(state: TrainState, batch, lr, cle_class_weights,
             pse_class_weights, key):
        grads, new_stats, metrics, preds = _micro_grads(
            state, batch, lr, cle_class_weights, pse_class_weights, key)
        new_state = apply_updates(state, grads, tx, lr)
        new_state = new_state.replace(batch_stats=new_stats)
        return new_state, metrics, preds

    @functools.partial(jax.jit, donate_argnums=(0,) if donate else ())
    def step_accum(state: TrainState, batch, lr, cle_class_weights,
                   pse_class_weights, key):
        b = batch["cls_label"].shape[0]
        assert b % accum_steps == 0, (b, accum_steps)
        micro = {k: v.reshape(accum_steps, b // accum_steps, *v.shape[1:])
                 for k, v in batch.items()}
        keys = jax.random.split(key, accum_steps)

        def body(carry, mb_and_key):
            st, gsum = carry
            mb, k = mb_and_key
            grads, stats, metrics, preds = _micro_grads(
                st, mb, lr, cle_class_weights, pse_class_weights, k)
            gsum = jax.tree.map(jnp.add, gsum, grads)
            return (st.replace(batch_stats=stats), gsum), (metrics, preds)

        gzero = jax.tree.map(jnp.zeros_like, state.params)
        (st, gsum), (metrics_s, preds_s) = jax.lax.scan(
            body, (state, gzero), (micro, keys))
        grads = jax.tree.map(lambda g: g / accum_steps, gsum)
        new_state = apply_updates(
            state.replace(batch_stats=st.batch_stats), grads, tx, lr)
        metrics = jax.tree.map(jnp.mean, metrics_s)
        preds = jax.tree.map(lambda p: p.reshape(b, *p.shape[2:]), preds_s)
        return new_state, metrics, preds

    return step_accum if accum_steps > 1 else step


def make_eval_step(model, mode: str, fused_input: bool = False,
                   target_size=(128, 224, 288)):
    """Eval step (VAL/TEST branch of ``shared_step``): forward + predicted
    labels (+ dense maps for the heatmap artifacts).

    ``fused_input=True``: the batch carries raw padded int16 volumes
    (``image_raw``/``lung_raw``/``in_sizes``) and the window/standardize/
    resize chain runs fused on the device — the same input pipeline the
    train phase uses, now serving val/test too (the reference applies one
    transform chain to all phases, ``models.py:55-80``)."""
    assert mode in ("cls", "reg")

    @jax.jit
    def step(state: TrainState, batch):
        images, lungs, _ = _batch_inputs(batch, fused_input, target_size)
        x = _nchw_to_ndhwc(images)
        lungs5 = _nchw_to_ndhwc(lungs.astype(jnp.float32))
        dense, heads = model.apply(state.variables, x, lungs5, train=False)
        if mode == "reg":
            pred_cle = ratio_to_label_batch(heads[0], CLE_RATIO_MAP)
            pred_pse = ratio_to_label_batch(heads[1], PSE_RATIO_MAP)
        else:
            pred_cle = jnp.argmax(heads[0], -1)
            pred_pse = jnp.argmax(heads[1], -1)
        return {"pred_cle_labels": pred_cle, "pred_pse_labels": pred_pse,
                "cle_labels": batch["cls_label"].astype(jnp.int32),
                "pse_labels": batch["pse_label"].astype(jnp.int32),
                "dense_cle": dense[0], "dense_pse": dense[1]}

    return step


def make_predict_step(model, batch_lung_norm: bool = False):
    """Deployment predict step (``models.py:430-450``).

    ``batch_lung_norm=False`` (default): lesion percentages divide by each
    sample's own lung volume — the statistically correct normalization and
    identical to the reference at the deployment batch of one scan.

    ``batch_lung_norm=True``: strict bit-parity with the reference, which
    divides every sample by the *whole batch's* lung volume
    (``models.py:440-441``, ``lungs.sum()`` with no per-sample dim) — use
    for validating outputs against reference runs at batch > 1.
    """

    @jax.jit
    def step(state: TrainState, images, lungs, ess):
        x = _nchw_to_ndhwc(images)
        lungs5 = _nchw_to_ndhwc(lungs.astype(jnp.float32))
        ess5 = _nchw_to_ndhwc(ess.astype(jnp.float32))
        dense, regs = model.apply(state.variables, x, lungs5, train=False)
        size = x.shape[1:4]
        cle_full = resize_linear_matmul(dense[0], size, (1, 2, 3),
                                        align_corners=True) * ess5
        pse_full = resize_linear_matmul(dense[1], size, (1, 2, 3),
                                        align_corners=True) * ess5
        if batch_lung_norm:
            lung_sums = jnp.sum(lungs5)
        else:
            lung_sums = jnp.sum(lungs5, axis=(1, 2, 3, 4))
        cle_pct = jnp.sum(cle_full, axis=(1, 2, 3, 4)) / lung_sums
        pse_pct = jnp.sum(pse_full, axis=(1, 2, 3, 4)) / lung_sums
        return {"cle_dense_outs": cle_full[..., 0],
                "pse_dense_outs": pse_full[..., 0],
                "cle_precentages": cle_pct, "pse_precentages": pse_pct}

    return step

#!/usr/bin/env python
"""End-to-end benchmarks on one NVIDIA GPU — ONE JSON line out.

Headline: median CT volumes/sec/chip through the batched deployment
pipeline of the flagship dRAM model (med3ddram == resnet34segreg, the
reference's deployment default, ``processor.py:59``):

  host int16 volumes (10-bit window-domain packed) + bit-packed lung masks
  → device transfer → fused on-device preprocess (window/standardize/resize
  + −910 ess mask) → forward → lesion percentages

Secondary fields in the same JSON line (medians):
  compute_only_vols_per_sec_per_chip — device-resident inputs
  train_vols_per_sec_per_chip        — bf16 donated train step (+ a 2x4
                                       gradient-accumulation step)
  processor_e2e_vols_per_sec         — the FULL deployment processor on
      synthetic 192^3 MHA pairs: MHA decode, lung dilate, bbox crop,
      forward, un-crop into original geometry, MHA+JSON writes

Every time ends in ``jax.block_until_ready``.  The JSON names the device
(platform, kind, count) and the card's power limit.  Without a GPU, or when
any phase fails, the script exits non-zero and prints no result.
"""
import argparse
import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BATCH = 4
PAD_SHAPE = (160, 288, 384)          # static padded raw-CT buffer
TARGET = (128, 224, 288)             # model input (train.py:30)
ITERS = 6
TRIALS = 5


def _timed_trials(run, n_vols):
    """Volumes/s of ``TRIALS`` calls of ``run`` (each ends in
    ``block_until_ready``)."""
    out = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        run()
        out.append(n_vols / (time.perf_counter() - t0))
    return out


def bench_inference(jax, jnp):
    from bodyct_dram_emph_subtype.data.host_preprocess import (
        depth_indices_np, resize_nearest_np, window_moments_np)
    from bodyct_dram_emph_subtype.models import get_model_by_name
    from bodyct_dram_emph_subtype.ops.packing import (
        gate_blocks_np, gated_budget, pack10_gated_host,
        unpack10_gated_device)
    from bodyct_dram_emph_subtype.ops.preprocess import \
        fused_preprocess_preselected
    from bodyct_dram_emph_subtype.ops.resize import \
        resize_linear_matmul_transpose

    model = get_model_by_name("med3ddram", dtype=jnp.bfloat16)
    x0 = jnp.zeros((1, *TARGET, 1), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, x0, x0, train=False))(
        jax.random.PRNGKey(0))
    # preselected + lung-gated transport: the host takes the exact linspace
    # depth slices, ships the standardize moments (exact int64 sums), the
    # lung nearest-preselected to TARGET, and ONLY the CT values inside
    # the dilated lung (everything outside is −2048 by the deployment
    # mask-out contract, reference ``dataset.py:69-70`` — the gate bits
    # reconstruct the clamped volume exactly)
    up_shape = (TARGET[0], PAD_SHAPE[1], PAD_SHAPE[2])
    n_vox_t = int(np.prod(TARGET))

    def make_pipeline(budget):
        @jax.jit
        def pipeline(variables, raw_packed, gate_bits, lung_bits, in_sizes,
                     moments):
            raw = unpack10_gated_device(raw_packed, gate_bits, up_shape)
            bits = jnp.right_shift(lung_bits[..., None],
                                   jnp.arange(8, dtype=jnp.uint8)) & 1
            lungs = bits.reshape(raw.shape[0], -1)[:, :n_vox_t].reshape(
                (raw.shape[0], *TARGET))
            pre = fused_preprocess_preselected(raw, lungs, in_sizes,
                                               moments, target_size=TARGET,
                                               em_threshold=-910.0)
            x = pre["image"][..., None]
            lungs5 = pre["lung_mask"][..., None]
            ess = pre["em_mask"][..., None]
            dense, regs = model.apply(variables, x, lungs5, train=False)
            # percentage math via the adjoint-resize identity (exactly the
            # deployment predict_packed program, inference/processor.py)
            half = dense[0].shape[1:4]
            ess_w = resize_linear_matmul_transpose(ess, half, (1, 2, 3),
                                                   align_corners=True)
            lung_sum = jnp.sum(lungs5, axis=(1, 2, 3, 4))
            cle_pct = jnp.sum(dense[0] * ess_w, axis=(1, 2, 3, 4)) / lung_sum
            pse_pct = jnp.sum(dense[1] * ess_w, axis=(1, 2, 3, 4)) / lung_sum
            # forces the deployment deliverables (half maps) to materialize
            checksum = jnp.sum(dense[0]) + jnp.sum(dense[1])
            return cle_pct, pse_pct, checksum
        return pipeline

    def make_host_batch(seed):
        """Deployment-shaped synthetic: an ellipsoid lung inside the bbox
        crop, CT masked to −2048 outside the 2x-dilated lung
        (``dataset.py:69-70``)."""
        r = np.random.RandomState(seed)
        img = r.randint(-1100, -700, (BATCH, *PAD_SHAPE)).astype(np.int16)
        zz, yy, xx = np.mgrid[:PAD_SHAPE[0], :PAD_SHAPE[1], :PAD_SHAPE[2]]
        lung1 = ((((zz - PAD_SHAPE[0] / 2) / (PAD_SHAPE[0] * 0.48)) ** 2
                  + ((yy - PAD_SHAPE[1] / 2) / (PAD_SHAPE[1] * 0.48)) ** 2
                  + ((xx - PAD_SHAPE[2] / 2) / (PAD_SHAPE[2] * 0.48)) ** 2)
                 < 1).astype(np.uint8)
        lung = np.broadcast_to(lung1, (BATCH, *PAD_SHAPE))
        gate1 = lung1
        for ax in range(3):                      # dilate x2, full 3^3
            for _ in range(2):
                up = np.roll(gate1, 1, axis=ax)
                dn = np.roll(gate1, -1, axis=ax)
                gate1 = np.maximum(gate1, np.maximum(up, dn))
        img[:, gate1 == 0] = -2048               # the mask-out contract
        sizes = np.tile(np.asarray(PAD_SHAPE, np.int32), (BATCH, 1))
        sizes[:, 0] -= r.randint(0, 16, BATCH)
        sel_img = np.empty((BATCH, *up_shape), np.int16)
        sel_lung = np.empty((BATCH, *TARGET), np.uint8)
        moments = np.empty((BATCH, 2), np.float32)
        for b in range(BATCH):
            d_in = int(sizes[b, 0])
            idx = depth_indices_np(d_in, TARGET[0])
            sel_img[b] = img[b, idx]
            sel_lung[b] = resize_nearest_np(lung[b, idx], TARGET[1:],
                                            (1, 2))
            moments[b] = window_moments_np(img[b, :d_in])
        gb = gate_blocks_np((sel_img > -1150).reshape(BATCH, -1))
        lung_bits = np.packbits(sel_lung.reshape(BATCH, -1), axis=-1,
                                bitorder="little")
        sizes[:, 0] = TARGET[0]
        counts = gb.sum(-1)          # touched blocks per sample
        return sel_img, gb, counts, lung_bits, sizes, moments

    raw_batches = [make_host_batch(s) for s in range(2)]
    budget = gated_budget([c for rb in raw_batches for c in rb[2]])
    pipeline = make_pipeline(budget)
    host_batches = []
    for sel_img, gb, _, lung_bits, sizes, moments in raw_batches:
        packed, blk_bits = pack10_gated_host(sel_img, gb, budget)
        host_batches.append((packed, blk_bits, lung_bits, sizes, moments))

    jax.block_until_ready(pipeline(variables, *[jax.device_put(a)
                                                for a in host_batches[0]]))

    def e2e():
        for it in range(ITERS):
            out = pipeline(variables, *[jax.device_put(a)
                                        for a in host_batches[it % 2]])
        jax.block_until_ready(out)

    dev = jax.block_until_ready([jax.device_put(a) for a in host_batches[0]])

    def compute_only():
        for _ in range(ITERS):
            out = pipeline(variables, *dev)
        jax.block_until_ready(out)

    return (_timed_trials(e2e, ITERS * BATCH),
            _timed_trials(compute_only, ITERS * BATCH))


def _train_batch(jnp, r, batch):
    return {
        "image": jnp.asarray(r.randn(batch, *TARGET).astype(np.float32)),
        "lung_mask": jnp.ones((batch, *TARGET), jnp.float32),
        "em_mask": jnp.asarray(
            (r.rand(batch, *TARGET) > 0.9).astype(np.float32)),
        "cls_label": jnp.asarray(r.randint(0, 6, batch), jnp.int32),
        "pse_label": jnp.asarray(r.randint(0, 3, batch), jnp.int32),
    }


def bench_train(jax, jnp, batch, accum_steps=1):
    """Median volumes/s of the bf16 donated dRAM train step at the
    trainer's default remat ("all")."""
    from bodyct_dram_emph_subtype.models import get_model_by_name
    from bodyct_dram_emph_subtype.train import (
        TrainState, make_optimizer, make_reg_train_step)

    model = get_model_by_name("med3ddram", dtype=jnp.bfloat16, remat="all")
    x0 = jnp.zeros((1, *TARGET, 1), jnp.float32)
    v = jax.jit(lambda k: model.init(k, x0, x0, train=False))(
        jax.random.PRNGKey(0))
    tx = make_optimizer()
    state = TrainState.create(dict(v), tx)
    step = make_reg_train_step(model, tx, num_data_shards=1, donate=True,
                               accum_steps=accum_steps)
    b = _train_batch(jnp, np.random.RandomState(0), batch)
    sargs = (jnp.asarray(1e-4), jnp.ones(6) / 6, jnp.ones(3) / 3,
             jax.random.PRNGKey(1))
    state, m, _ = step(state, b, *sargs)
    jax.block_until_ready(state)

    def run():
        nonlocal state
        for _ in range(3):
            state, m, _ = step(state, b, *sargs)
        jax.block_until_ready((state, m))

    return _timed_trials(run, 3 * batch)


def bench_processor():
    """Full deployment processor on synthetic 192^3 MHA pairs, everything
    included; volumes/s of fresh runs after one compile run."""
    from bodyct_dram_emph_subtype.data.mha import write_mha
    from bodyct_dram_emph_subtype.inference import run_inference

    n_scans = 8
    shape = (192, 192, 192)
    root = Path(tempfile.mkdtemp(prefix="bench_proc_"))
    scan_dir = root / "input" / "images" / "ct"
    lobe_dir = root / "input" / "images" / "pulmonary-lobes"
    out_dir = root / "output"
    scan_dir.mkdir(parents=True)
    lobe_dir.mkdir(parents=True)
    try:
        zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
        lobe = ((((zz - 96) / 70.0) ** 2 + ((yy - 96) / 60.0) ** 2
                 + ((xx - 96) / 70.0) ** 2) < 1)
        for i in range(n_scans):
            r = np.random.RandomState(i)
            ct = np.full(shape, -600, np.int16)
            ct[lobe] = (-880 + 60 * r.randn(int(lobe.sum()))).astype(np.int16)
            write_mha(scan_dir / f"scan{i}.mha", ct, (0.7, 0.7, 0.7),
                      (0.0, 0.0, 0.0))
            write_mha(lobe_dir / f"scan{i}.mha", lobe.astype(np.uint8),
                      (0.7, 0.7, 0.7), (0.0, 0.0, 0.0))
        # pad_shape sized to this cohort's lung crops (a deployment sizes
        # its static buffer to its population); batch_size 4 is the
        # reference test-time batch (test.py:36)
        kwargs = dict(model_arch="med3ddram", ckp_path=None,
                      target_size=TARGET, batch_size=4, workers=2, nchips=1,
                      compute_dtype="bfloat16", pad_shape=(160, 160, 160),
                      device_preprocess=True)

        def run():
            shutil.rmtree(out_dir, ignore_errors=True)
            out_dir.mkdir()
            results = run_inference(str(scan_dir), str(lobe_dir),
                                    str(out_dir), **kwargs)
            if len(results) != n_scans:
                raise RuntimeError(f"processor returned {len(results)} of "
                                   f"{n_scans} scans")

        run()                          # compiles the predict program
        return _timed_trials(run, n_scans)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def card_power_limit() -> str:
    """``nvidia-smi`` name and power limit, from a child that stays off
    JAX."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _med(samples, n_dev=1):
    return round(float(np.median(samples)) / n_dev, 3)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--skip-train", action="store_true")
    p.add_argument("--skip-processor", action="store_true")
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: needs an NVIDIA GPU; JAX found "
              f"{devices[0].platform!r} devices", file=sys.stderr)
        return 2
    from bodyct_dram_emph_subtype.utils.cli import enable_compile_cache
    enable_compile_cache()
    n_dev = len(devices)

    e2e, compute = bench_inference(jax, jnp)
    result = {
        "metric": "ct_volumes_per_sec_per_chip_e2e",
        "value": _med(e2e, n_dev),
        "unit": "volumes/s/chip (median)",
        "e2e_samples": [round(s, 3) for s in e2e],
        "compute_only_vols_per_sec_per_chip": _med(compute, n_dev),
        "batch": BATCH,
        "model": "med3ddram(resnet34segreg)",
        "device": {"platform": devices[0].platform,
                   "kind": devices[0].device_kind, "count": n_dev},
        "card": card_power_limit(),
    }
    if not args.skip_train:
        train = bench_train(jax, jnp, BATCH)
        accum = bench_train(jax, jnp, 2 * BATCH, accum_steps=2)
        result.update(
            train_vols_per_sec_per_chip=_med(train, n_dev),
            train_batch=BATCH,
            train_ms_per_step=round(BATCH / float(np.median(train)) * 1e3, 1),
            train_accum_vols_per_sec_per_chip=_med(accum, n_dev),
            train_accum_batch=2 * BATCH, train_accum_microbatches=2)
    if not args.skip_processor:
        result["processor_e2e_vols_per_sec"] = _med(bench_processor())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

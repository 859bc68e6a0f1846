#!/usr/bin/env python
"""Smoke run of the main path on an NVIDIA GPU.

    python chip_smoke.py             # one card: processor, train, parity
    python chip_smoke.py --cards 4   # four cards: data-parallel phases only

Phases on one card, each at real size with random weights from a seed:

- device:    the first JAX device is a GPU; prints its name and power limit;
- processor: ``run_inference`` (what ``processor.py`` calls) on chest-CT
  sized MHA pairs (~300 slices of 512², 0.7 mm in-plane) with the full
  ``med3ddram`` at 128×224×288, bf16, device preprocessing; one scan's lung
  box exceeds ``--pad_shape`` and takes the per-scan host path.  Checks the
  three JSONs, both heatmap MHA trees, score ranges, and the lesion
  percentages against a float32 host-preprocess run at matmul precision
  ``highest``;
- train:     ``SubtypeTrainer`` (what ``train.py`` drives) on a fabricated
  ``.npz`` archive of lung-crop sized volumes: ``med3ddram`` at 128×224×288,
  B=4, bf16, device input pipeline, default remat — one short epoch, eval,
  checkpoint save, resume.  Checks finite losses and that the resumed
  state equals the saved one;
- parity:    forward and one train step at a small shape on the card and on
  the host CPU backend, both float32 at precision ``highest``, with
  BatchNorm statistics calibrated on the input so the maps are not
  saturated.

``--cards 4`` runs a ``med3ddram`` bf16 train step on a ``data=4`` mesh
against the same global batch on one card, and ``run_inference`` with
``nchips=4`` against one card.

Exits non-zero when JAX finds no GPU or when any phase fails.  The last
line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

TARGET = (128, 224, 288)       # model input (reference train.py:30)
PAD = (160, 288, 384)          # processor.py --pad_shape default


def log(*args):
    print(*args, flush=True)


class SmokeFailure(AssertionError):
    pass


def check(ok, detail="") -> None:
    """Raise when a smoke check fails (unlike ``assert``, kept under -O)."""
    if not ok:
        raise SmokeFailure(detail)


def card_info() -> str:
    """``nvidia-smi`` name and power limit, from a child that stays off
    JAX."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip()


def device_memory(tag: str):
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[{tag}] peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


# --------------------------------------------------------------------------
# synthetic inputs
# --------------------------------------------------------------------------

def _ellipsoid(shape, radii):
    axes = [((np.arange(n, dtype=np.float32) - n / 2) / r) ** 2
            for n, r in zip(shape, radii)]
    r2 = (axes[0][:, None, None] + axes[1][None, :, None]
          + axes[2][None, None, :])
    return r2 < 1.0


def _ct(rng, shape, lung):
    """int16 HU volume: soft tissue, lung parenchyma around −860 HU with a
    tail below −950 (emphysema-like), air outside the body."""
    body = _ellipsoid(shape, (shape[0], shape[1] * 0.47, shape[2] * 0.47))
    ct = np.where(body, np.int16(40), np.int16(-1000))
    ct[lung] = (-860 + 60 * rng.standard_normal(int(lung.sum()),
                                                np.float32)).astype(np.int16)
    return ct


def make_scans(root: Path, n_scans: int, shape, lung_radii, seed: int = 0,
               oversized_radii=None):
    """``n_scans`` CT/lobe MHA pairs (+ one whose lung box exceeds the
    processor's in-plane ``--pad_shape`` when ``oversized_radii`` is
    given).  Geometry: 0.7 mm in-plane, 1 mm slices."""
    from bodyct_dram_emph_subtype.data.mha import write_mha

    scan_dir, lobe_dir = root / "ct", root / "lobes"
    scan_dir.mkdir(parents=True)
    lobe_dir.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    cases = [(f"scan{i}", lung_radii) for i in range(n_scans)]
    if oversized_radii is not None:
        cases.append(("scan_oversized", oversized_radii))
    for uid, radii in cases:
        lung = _ellipsoid(shape, radii)
        spacing, origin = (0.7, 0.7, 1.0), (-180.0, -180.0, -150.0)
        write_mha(scan_dir / f"{uid}.mha", _ct(rng, shape, lung), spacing,
                  origin)
        write_mha(lobe_dir / f"{uid}.mha", lung.astype(np.uint8), spacing,
                  origin)
    return scan_dir, lobe_dir, [uid for uid, _ in cases]


def make_archive(root: Path, n_series: int, shape, seed: int = 0):
    """A training cache (``{uid}.npz`` + ``merged.csv``) of lung-crop sized
    int16 volumes, CLE labels 0..5 and PSE labels 0..2 round robin."""
    root.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    lung = _ellipsoid(shape, [n * 0.45 for n in shape])
    rows = ["SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
            "CT_Visual_Emph_Paraseptal_P1"]
    for i in range(n_series):
        uid = f"series{i:03d}"
        rows.append(f"{uid},{i % 6},{i % 3}")
        np.savez(root / f"{uid}.npz", image=_ct(rng, shape, lung),
                 lung_mask=lung, cls_label=i % 6, pse_label=i % 3)
    (root / "merged.csv").write_text("\n".join(rows) + "\n")
    return root / "merged.csv"


def calibrated_state(model, x, lungs, seed: int = 0):
    """A train state of random weights from ``seed`` whose BatchNorm
    running statistics are one batch's statistics (``x``, ``lungs``).
    Random weights under the initial running statistics (0, 1) leave every
    activation unnormalised and saturate the sigmoid maps at 0 or 1, and a
    comparison of saturated maps tests nothing.  Host arrays, so jit places
    them wherever the inputs are."""
    from bodyct_dram_emph_subtype.models.blocks import NormWrapper
    from bodyct_dram_emph_subtype.train import TrainState, make_optimizer

    xs = jnp.zeros((1, 16, 32, 32, 1), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, xs, xs, train=False))(
        jax.random.PRNGKey(seed))
    _, mutated = jax.jit(lambda v, x, l: model.apply(
        v, x, l, train=True, mutable=["batch_stats"]))(variables, x, lungs)
    m = NormWrapper.momentum      # new = m·old + (1−m)·batch
    stats = jax.tree.map(lambda new, old: (new - m * old) / (1 - m),
                         mutated["batch_stats"], variables["batch_stats"])
    return jax.device_get(TrainState.create(
        {"params": variables["params"], "batch_stats": stats},
        make_optimizer()))


def _calibration_input(batch, target_size, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *target_size, 1), np.float32)
    return jnp.asarray(x), jnp.ones((batch, *target_size, 1), jnp.float32)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def _percentages(results):
    return {r["entity"]: (float(r["metrics"]["cle_lesion_percentage_per_lung"]),
                          float(r["metrics"]["pse_lesion_percentage_per_lung"]))
            for r in results}


def check_outputs(out_dir: Path, results, uids, scan_shape):
    """The processor's output contract (reference processor.py:76-177)."""
    from bodyct_dram_emph_subtype.data.mha import read_mha

    check(sorted(r["entity"] for r in results) == sorted(uids), results)
    for name in ("centrilobular-emphysema-score.json",
                 "araseptal-emphysema-score.json"):
        score = json.loads((out_dir / name).read_text())
        check(set(score) == {"score", "percentage"}, score)
    check(len(json.loads((out_dir / "results.json").read_text())) == len(uids))
    for tree in ("centrilobular-emphysema-heatmap",
                 "paraseptal-emphysema-heatmap"):
        for uid in uids:
            img = read_mha(out_dir / "images" / tree / f"{uid}.mha")
            check(img.array.shape == tuple(scan_shape), img.array.shape)
            check(img.array.dtype == np.uint8)
    for r in results:
        m = r["metrics"]
        check(0 <= int(m["cle_severity_score"]) <= 5, m)
        check(0 <= int(m["pse_severity_score"]) <= 2, m)
        for k in ("cle_lesion_percentage_per_lung",
                  "pse_lesion_percentage_per_lung"):
            check(0.0 <= float(m[k]) <= 1.0, m)


# bf16 keeps 8 mantissa bits (relative step 2^-8 ≈ 3.9e-3).  Rounding every
# conv input of the 34-layer model moves the sigmoid maps by ~5e-3 on
# average against float32; a lesion percentage is a masked mean of those
# maps, so 2e-2 absolute leaves a factor of four.  The device and host
# preprocessing paths agree to <1e-5 (exact integer resize index math).
PCT_ATOL_BF16 = 2e-2


def processor_phase(work: Path, *, arch="med3ddram", scan_shape=(300, 512, 512),
                    n_scans=4, lung_radii=(120, 125, 165),
                    oversized_radii=(120, 125, 205), target_size=TARGET,
                    pad_shape=PAD, batch_size=2, workers=2):
    from bodyct_dram_emph_subtype.inference import run_inference
    from bodyct_dram_emph_subtype.models import get_model_by_name

    t0 = time.perf_counter()
    scan_dir, lobe_dir, uids = make_scans(work / "in", n_scans, scan_shape,
                                          lung_radii, seed=0,
                                          oversized_radii=oversized_radii)
    log(f"[processor] wrote {len(uids)} scans {scan_shape} in "
        f"{time.perf_counter() - t0:.1f}s")
    state = jax.device_put(calibrated_state(
        get_model_by_name(arch, dtype=jnp.bfloat16),
        *_calibration_input(1, target_size)))
    kw = dict(model_arch=arch, state=state, target_size=target_size,
              pad_shape=pad_shape, batch_size=batch_size, workers=workers,
              nchips=1)
    times = {}
    for run in ("first", "steady"):
        out = work / f"out_bf16_{run}"
        t0 = time.perf_counter()
        bf16 = run_inference(str(scan_dir), str(lobe_dir), str(out),
                             compute_dtype="bfloat16", **kw)
        times[run] = time.perf_counter() - t0
        check_outputs(out, bf16, uids, scan_shape)
    log(f"[processor] bf16 device-preprocess run: first (compile) "
        f"{times['first']:.1f}s, steady {times['steady']:.1f}s for "
        f"{len(uids)} scans ({times['steady'] / len(uids):.2f} s/scan)")
    device_memory("processor")
    t0 = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        f32 = run_inference(str(scan_dir), str(lobe_dir),
                            str(work / "out_f32"), compute_dtype="float32",
                            device_preprocess=False, **kw)
    log(f"[processor] float32 host-preprocess reference run "
        f"{time.perf_counter() - t0:.1f}s")
    check_outputs(work / "out_f32", f32, uids, scan_shape)
    got, want = _percentages(bf16), _percentages(f32)
    worst = max(abs(a - b) for u in uids for a, b in zip(got[u], want[u]))
    for u in uids:
        log(f"[processor] {u}: bf16 cle/pse {got[u]}  float32 {want[u]}")
    log(f"[processor] max |bf16 - float32| lesion percentage = {worst:.4f} "
        f"(tolerance {PCT_ATOL_BF16})")
    check(worst <= PCT_ATOL_BF16, worst)
    return {"scans": len(uids), "first_s": times["first"],
            "steady_s": times["steady"], "max_pct_diff": worst}


def _states_equal(a, b):
    la, lb = jax.tree.leaves(jax.device_get(a)), jax.tree.leaves(
        jax.device_get(b))
    check(jax.tree.structure(a) == jax.tree.structure(b))
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(la, lb))


def _raw_batch(archive: Path, uids, pad_shape):
    """The device input pipeline's batch for ``uids`` (RawPaddedView)."""
    images, lungs, sizes = [], [], []
    for uid in uids:
        with np.load(archive / f"{uid}.npz") as z:
            img, lung = z["image"], z["lung_mask"]
        pad = [(0, p - s) for s, p in zip(img.shape, pad_shape)]
        images.append(np.pad(img, pad, constant_values=-2048))
        lungs.append(np.pad(lung.astype(np.uint8), pad))
        sizes.append(img.shape)
    n = len(uids)
    return {"image_raw": np.stack(images), "lung_raw": np.stack(lungs),
            "in_sizes": np.asarray(sizes, np.int32),
            "cls_label": np.arange(n, dtype=np.int32) % 6,
            "pse_label": np.arange(n, dtype=np.int32) % 3}


def train_phase(work: Path, *, arch="med3ddram", raw_shape=(200, 240, 320),
                pad_shape=(208, 256, 336), target_size=TARGET, batch_size=4,
                n_series=8, num_samples=2, workers=4, timed_steps=3):
    from bodyct_dram_emph_subtype.train import (SubtypeTrainer,
                                                TrainerConfig)
    from bodyct_dram_emph_subtype.train.steps import make_reg_train_step

    t0 = time.perf_counter()
    csv = str(make_archive(work / "archive", n_series, raw_shape))
    log(f"[train] wrote {n_series} series {raw_shape} in "
        f"{time.perf_counter() - t0:.1f}s")
    cfg = TrainerConfig(
        model_arch=arch, lr=1e-4, max_epochs=1, batch_size=batch_size,
        num_samples=num_samples, target_size=tuple(target_size),
        workers=workers, data_path=str(work / "archive"), train_csv=csv,
        valid_csv=csv, test_csv=csv, model_path=str(work / "models"),
        nchips=1, seed=0, sampler_seed=0, compute_dtype="bfloat16",
        input_pipeline="device", pad_shape=tuple(pad_shape),
        debug_draw_batches=1)
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.setup_checkpointing()
    t0 = time.perf_counter()
    trainer.fit()                       # epoch 0: steps, save, eval
    t_fit = time.perf_counter() - t0
    loss = trainer.epoch_train_losses[0]
    n_steps = int(trainer.state.step)
    log(f"[train] epoch 0: {n_steps} steps of B={batch_size} + eval + "
        f"checkpoint in {t_fit:.1f}s (compiles included); mean loss "
        f"{loss:.4f}")
    check(n_steps >= 2 and np.isfinite(loss), (n_steps, loss))
    check(trainer.ckpt.latest_epoch() == 0)

    resumed = SubtypeTrainer(cfg)
    resumed.init_state()
    resumed.setup_checkpointing()
    check(resumed.try_resume(reload_only_weights=False))
    check(resumed.epoch == 1, resumed.epoch)
    check(_states_equal(resumed.state, trainer.state), "resume differs")
    log("[train] resume from the epoch-0 checkpoint: state equal")

    # the trainer's step program alone: compile, memory, steady step time
    step = make_reg_train_step(trainer.model, trainer.tx, 1,
                               fused_input=True,
                               target_size=tuple(target_size), donate=True)
    from bodyct_dram_emph_subtype.data import COPDGeneSubtyping
    uids = COPDGeneSubtyping.get_series_uids(csv)[:batch_size]
    batch = jax.device_put(_raw_batch(work / "archive", uids, pad_shape))
    args = (jnp.float32(1e-4), jnp.ones(6, jnp.float32) / 6,
            jnp.ones(3, jnp.float32) / 3, jax.random.PRNGKey(0))
    state = resumed.state
    t0 = time.perf_counter()
    compiled = step.lower(state, batch, *args).compile()
    t_compile = time.perf_counter() - t0
    log(f"[train] step compile {t_compile:.1f}s; memory_analysis: "
        f"{compiled.memory_analysis()}")
    state, metrics, _ = compiled(state, batch, *args)
    jax.block_until_ready(state)
    ts = []
    for _ in range(timed_steps):
        t0 = time.perf_counter()
        state, metrics, _ = compiled(state, batch, *args)
        jax.block_until_ready((state, metrics))
        ts.append(time.perf_counter() - t0)
    losses = {k: float(v) for k, v in metrics.items()}
    check(all(np.isfinite(v) for v in losses.values()), losses)
    log(f"[train] steady step ms {[round(t * 1e3, 2) for t in ts]} "
        f"median {np.median(ts) * 1e3:.2f}; losses {losses}")
    device_memory("train")
    return {"steps": n_steps, "epoch_loss": loss, "fit_s": t_fit,
            "step_compile_s": t_compile,
            "step_median_ms": float(np.median(ts) * 1e3)}


# float32 on both backends under precision "highest" (no TF32 on the card):
# only the summation order differs, a few ulp per reduction, compounded
# through 34 layers.  Dense maps are sigmoids in [0, 1]: their bound is
# 1e-4 absolute, i.e. 1e-4 of the map's range.  The train step's losses and
# batch statistics are sums over ~10^5 voxels per sample on top of that
# (measured 1.3e-4 relative on an H100), so they get 5e-4.
PARITY_RTOL, PARITY_ATOL = 1e-4, 1e-5
PARITY_MAP_ATOL = 1e-4
PARITY_SUM_RTOL = 5e-4


def _host_batch(rng, shape):
    b = shape[0]
    return {"image": rng.standard_normal(shape).astype(np.float32),
            "lung_mask": (rng.random(shape) > 0.3).astype(np.float32),
            "em_mask": (rng.random(shape) > 0.8).astype(np.float32),
            "cls_label": np.arange(b, dtype=np.int32) % 6,
            "pse_label": np.arange(b, dtype=np.int32) % 3}


def _flat(tree):
    return np.concatenate([np.ravel(np.asarray(x, np.float64))
                           for x in jax.tree.leaves(tree)])


def _rel_l2(a_tree, b_tree) -> float:
    a, b = _flat(a_tree), _flat(b_tree)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cos(a_tree, b_tree) -> float:
    a, b = _flat(a_tree), _flat(b_tree)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def surrogate_grad(model):
    """Jitted gradient, w.r.t. the params, of a smooth function of the
    train-mode forward (mean squared dense maps plus the lesion fractions).

    The training loss itself is ill-conditioned at random weights — its
    interval term differentiates x^0.2578 near x = 0 — so a change of
    summation order moves its gradient far more than rounding (float32,
    med3ddram18 at 32×48×64 on the CPU: 4-device vs 1-device relative L2
    of 8.8).  This surrogate runs the same backward through every layer
    without that amplification."""
    def f(params, stats, x, lungs):
        (dense, regs), _ = model.apply(
            {"params": params, "batch_stats": stats}, x, lungs, train=True,
            mutable=["batch_stats"])
        return (sum(jnp.mean(jnp.square(d.astype(jnp.float32)))
                    for d in dense) + sum(jnp.sum(r) for r in regs))
    return jax.jit(jax.grad(f))


# Gradients, float32, another summation order: ReLU masks of activations
# within rounding of 0 flip, so gradients move by more than the forward.
# Measured on the CPU for a 4-way data split of med3ddram at 32×48×64:
# relative L2 9.8e-3, cosine 0.99995.
GRAD_REL_L2, GRAD_COS = 2e-2, 0.9999


def _check_grads(tag, got, want):
    err, cos = _rel_l2(got, want), _cos(got, want)
    log(f"[{tag}] gradients: |Δg|/|g| {err:.3e} (<= {GRAD_REL_L2}), "
        f"cos {cos:.6f} (>= {GRAD_COS})")
    check(err <= GRAD_REL_L2 and cos >= GRAD_COS, (err, cos))
    return err, cos


def parity_phase(*, arch="med3ddram", shape=(2, 32, 48, 64), device=None):
    """Card vs host CPU, float32 at precision highest: eval forward, one
    train step (losses and new batch statistics) and the parameter
    gradient of :func:`surrogate_grad`."""
    from bodyct_dram_emph_subtype.models import get_model_by_name
    from bodyct_dram_emph_subtype.train import (make_optimizer,
                                                make_reg_train_step)

    device = device or jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    model = get_model_by_name(arch)
    host = _host_batch(np.random.default_rng(0), shape)
    with jax.default_device(cpu), jax.default_matmul_precision("highest"):
        state = calibrated_state(
            model, jnp.asarray(host["image"])[..., None],
            jnp.asarray(host["lung_mask"])[..., None])
    fwd = jax.jit(lambda v, x, l: model.apply(v, x, l, train=False))
    step = make_reg_train_step(model, make_optimizer(), 1, augment=False)
    grad = surrogate_grad(model)
    args = (np.float32(1e-4), np.ones(6, np.float32) / 6,
            np.ones(3, np.float32) / 3, np.asarray(jax.random.PRNGKey(1)))
    out = {}
    with jax.default_matmul_precision("highest"):
        for side, dev in (("device", device), ("host", cpu)):
            put = lambda t, d=dev: jax.device_put(t, d)  # noqa: E731
            st, hb = put(state), put(host)
            x, lungs = hb["image"][..., None], hb["lung_mask"][..., None]
            dense, regs = fwd(st.variables, x, lungs)
            g = grad(st.params, st.batch_stats, x, lungs)
            new, metrics, _ = step(st, hb, *put(args))
            out[side] = jax.device_get(
                {"dense": dense, "regs": regs, "metrics": metrics,
                 "batch_stats": new.batch_stats, "grads": g})
    got, want = out["device"], out["host"]
    for key in ("dense", "regs", "metrics", "batch_stats"):
        pairs = list(zip(jax.tree.leaves(got[key]),
                         jax.tree.leaves(want[key])))
        worst_abs = max(float(np.max(np.abs(a - b))) for a, b in pairs)
        worst_rel = max(float(np.max(np.abs(a - b) / (np.abs(b) + 1e-30)))
                        for a, b in pairs)
        log(f"[parity] {key}: max |Δ| {worst_abs:.3e}, max |Δ|/|ref| "
            f"{worst_rel:.3e}")
        rtol, atol = {"dense": (0.0, PARITY_MAP_ATOL),
                      "regs": (PARITY_RTOL, PARITY_ATOL)}.get(
                          key, (PARITY_SUM_RTOL, PARITY_ATOL))
        for a, b in pairs:
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=key)
    err, cos = _check_grads("parity", got["grads"], want["grads"])
    log(f"[parity] {arch} {shape} {device.platform} vs cpu: regressions "
        f"within rtol {PARITY_RTOL}, losses and batch_stats within rtol "
        f"{PARITY_SUM_RTOL}, maps within {PARITY_MAP_ATOL}; loss "
        f"{float(got['metrics']['loss']):.6f} vs "
        f"{float(want['metrics']['loss']):.6f}")
    return {"loss_gpu": float(got["metrics"]["loss"]),
            "loss_cpu": float(want["metrics"]["loss"]),
            "grad_rel_l2": err, "grad_cos": cos}


# bf16 activations: the 4-way run reduces BN statistics in another order
# than one card, and cuDNN may pick other algorithms for a per-card batch
# of 1 than for 4; each flips bf16 roundings (relative step 2^-8 ≈ 3.9e-3)
# that compound through the layers.  So the losses and the new batch
# statistics agree to 1e-2 relative (statistics in relative L2), not
# bitwise.
DP_LOSS_RTOL = 1e-2
DP_STATS_REL_L2 = 1e-2
DP_PCT_ATOL = 2e-3


def dp_train_phase(*, arch="med3ddram", shape=(4, *TARGET), cards=4,
                   grad_shape=(4, 32, 48, 64)):
    """A ``data=cards`` mesh against one card on the same global batch:
    one bf16 train step (losses, and the cross-card BatchNorm statistics
    it leaves), and the float32 parameter gradient of
    :func:`surrogate_grad` at ``grad_shape``."""
    from bodyct_dram_emph_subtype.models import get_model_by_name
    from bodyct_dram_emph_subtype.parallel.mesh import (MeshSpec, get_mesh,
                                                        shard_batch)
    from bodyct_dram_emph_subtype.train import (TrainState, make_optimizer,
                                                make_reg_train_step)

    model = get_model_by_name(arch, dtype=jnp.bfloat16, remat="all")
    tx = make_optimizer()
    xs = jnp.zeros((1, 16, 32, 32, 1), jnp.float32)
    variables = jax.jit(lambda k: model.init(k, xs, xs, train=False))(
        jax.random.PRNGKey(0))
    state0 = TrainState.create(dict(variables), tx)
    host = _host_batch(np.random.default_rng(1), shape)
    small = _host_batch(np.random.default_rng(2), grad_shape)
    args = (jnp.float32(1e-4), jnp.ones(6, jnp.float32) / 6,
            jnp.ones(3, jnp.float32) / 3, jax.random.PRNGKey(1))
    # the per-shard sum losses divide by the data width: both runs use the
    # 4-way scaling, so the global step is the same computation
    step = make_reg_train_step(model, tx, num_data_shards=cards,
                               augment=False)
    grad = surrogate_grad(get_model_by_name(arch))
    res = {}
    for n in (1, cards):
        mesh = get_mesh(MeshSpec(data=n), devices=jax.devices()[:n])
        t0 = time.perf_counter()
        new, metrics, _ = step(state0, shard_batch(mesh, host), *args)
        sb = shard_batch(mesh, {k: small[k] for k in ("image", "lung_mask")})
        with jax.default_matmul_precision("highest"):
            g = grad(variables["params"], variables["batch_stats"],
                     sb["image"][..., None], sb["lung_mask"][..., None])
        res[n] = jax.device_get({"metrics": metrics,
                                 "stats": new.batch_stats, "grads": g})
        log(f"[dp-train] data={n}: loss {float(metrics['loss']):.6f} "
            f"({time.perf_counter() - t0:.1f}s incl. compile)")
    one, many = res[1], res[cards]
    for k, v in one["metrics"].items():
        rel = abs(float(many["metrics"][k]) - float(v)) / abs(float(v))
        log(f"[dp-train] {k}: data={cards} vs 1 card rtol {rel:.2e} "
            f"(<= {DP_LOSS_RTOL})")
        check(rel <= DP_LOSS_RTOL, (k, float(v), float(many["metrics"][k])))
    stats_err = _rel_l2(many["stats"], one["stats"])
    log(f"[dp-train] batch_stats |Δ|/|s| {stats_err:.2e} "
        f"(<= {DP_STATS_REL_L2})")
    check(stats_err <= DP_STATS_REL_L2, stats_err)
    err, cos = _check_grads("dp-train", many["grads"], one["grads"])
    return {"loss_1": float(one["metrics"]["loss"]),
            "loss_dp": float(many["metrics"]["loss"]),
            "stats_rel_l2": stats_err, "grad_rel_l2": err, "grad_cos": cos}


def dp_processor_phase(work: Path, *, arch="med3ddram", cards=4,
                       scan_shape=(300, 512, 512), lung_radii=(120, 125, 165),
                       target_size=TARGET, pad_shape=PAD, workers=2):
    """``run_inference`` with ``nchips=cards`` vs one card, one scan per
    card, bf16."""
    from bodyct_dram_emph_subtype.inference import run_inference
    from bodyct_dram_emph_subtype.models import get_model_by_name

    scan_dir, lobe_dir, uids = make_scans(work / "in", cards, scan_shape,
                                          lung_radii, seed=1)
    state = jax.device_put(calibrated_state(
        get_model_by_name(arch, dtype=jnp.bfloat16),
        *_calibration_input(1, target_size)))
    pct = {}
    for n in (1, cards):
        t0 = time.perf_counter()
        out = work / f"out_{n}"
        results = run_inference(str(scan_dir), str(lobe_dir), str(out),
                                model_arch=arch, state=state,
                                target_size=target_size, pad_shape=pad_shape,
                                batch_size=1, workers=workers, nchips=n,
                                compute_dtype="bfloat16")
        check_outputs(out, results, uids, scan_shape)
        pct[n] = _percentages(results)
        log(f"[dp-processor] nchips={n}: {len(uids)} scans in "
            f"{time.perf_counter() - t0:.1f}s (compile included)")
    worst = max(abs(a - b) for u in uids
                for a, b in zip(pct[1][u], pct[cards][u]))
    log(f"[dp-processor] max |nchips={cards} - 1| lesion percentage "
        f"{worst:.4f} (tolerance {DP_PCT_ATOL})")
    check(worst <= DP_PCT_ATOL, worst)
    return {"max_pct_diff": worst}


# --------------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = parser.parse_args(argv)

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found "
              f"{devices[0].platform!r} devices {devices}", file=sys.stderr)
        return 2
    if len(devices) < args.cards:
        print(f"chip_smoke: --cards {args.cards} needs {args.cards} GPUs, "
              f"found {len(devices)}", file=sys.stderr)
        return 2
    from bodyct_dram_emph_subtype.utils.cli import enable_compile_cache
    log(f"[device] jax {jax.__version__}; {len(devices)} x "
        f"{devices[0].device_kind}; compile cache {enable_compile_cache()}")
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        work = Path(tmp)
        if args.cards == 1:
            phases = [("processor", lambda: processor_phase(work / "proc")),
                      ("train", lambda: train_phase(work / "train")),
                      ("parity", parity_phase)]
        else:
            phases = [("dp-train", lambda: dp_train_phase(cards=args.cards)),
                      ("dp-processor", lambda: dp_processor_phase(
                          work / "dp", cards=args.cards))]
        for name, run in phases:
            t0 = time.perf_counter()
            report = run()
            log(f"[{name}] ok in {time.perf_counter() - t0:.1f}s: {report}")
    log(f"[done] all phases ok in {time.perf_counter() - t_all:.1f}s")
    log(f"[device] card: {card_info()}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

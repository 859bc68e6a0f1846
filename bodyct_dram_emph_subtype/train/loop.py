"""The training system: explicit epoch loop replacing PyTorch-Lightning.

Orchestration parity with ``ScanCLSLightningModule`` /
``ScanRegLightningModule`` + ``SubtypeDataModule`` + the ``train.py`` CLI:

- CLE-stratified sampling with per-epoch reshuffling and per-process index
  sharding (``models.py:99-123``);
- host loader threads deliver fixed-shape float32 batches (deterministic
  window/standardize/interpolate); the random augmentations + forward +
  losses + Adam update run as ONE jitted program on the mesh;
- cross-replica BatchNorm via GSPMD (``sync_batchnorm=True`` parity);
- per-epoch artifacts on process 0: confusion-matrix PNGs, prediction CSVs,
  heatmap tiles for the first eval batches, accuracy logs
  (``models.py:266-341``);
- adaptive class re-weighting after each training epoch (CLS strategy only,
  ``models.py:369-379``);
- every-epoch checkpoints + auto-resume + greedy torch reload
  (``train.py:77-99``);
- Adam lr decays ×0.95 per epoch (``models.py:685-698``).
"""
from __future__ import annotations

import csv
import dataclasses
import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..data import (
    COPDGeneSubtyping,
    DataLoader,
    SubtypingStratifiedSampler,
    shard_indices,
)
from ..data.host_preprocess import PreprocessedView
from ..models import get_model_by_name
from ..parallel.mesh import get_mesh, process_local_data, shard_batch
from ..utils.viz import (
    draw_mask_tile_singleview_heatmap,
    plot_confusion_matrix_from_data,
    plot_to_numpy_array,
    save_image,
    windowing,
)
from .checkpoint import CheckpointManager, greedy_restore_variables
from .state import TrainState, epoch_lr, make_optimizer
from .steps import (
    make_cls_train_step,
    make_eval_step,
    make_predict_step,
    make_reg_train_step,
)

logger = logging.getLogger(__name__)

TRAIN_PHASE = "train"
VALID_PHASE = "validate"
TEST_PHASE = "test"


@dataclasses.dataclass
class TrainerConfig:
    model_arch: str = "med3ddram"
    lr: float = 1e-4
    max_epochs: int = 120
    batch_size: int = 1
    num_samples: int = 128          # per-class resample count
    target_size: Tuple[int, int, int] = (128, 224, 288)
    workers: int = 2
    data_path: str = ""
    train_csv: str = ""
    valid_csv: str = ""
    test_csv: str = ""
    model_path: str = "./models"
    nchips: Optional[int] = None    # data-parallel width (None == all devices)
    seed: int = 0
    debug_draw_batches: int = 50
    check_val_every_n_epoch: int = 1
    sampler_seed: Optional[int] = None   # None == wall-clock (reference)
    compute_dtype: str = "float32"       # "bfloat16" for the fast path
    profile: bool = False                # jax.profiler trace of epoch 0
    debug_nans: bool = False             # opt-in NaN checking
    input_pipeline: str = "host"         # "host" or "device" (fused preprocess)
    pad_shape: Optional[Tuple[int, int, int]] = None  # device-pipeline buffer
    mesh: Optional[str] = None           # e.g. "data=2,spatial=2,model=2";
    # None == all requested chips on the data axis (reference DDP parity)
    remat: str = "all"                   # activation checkpointing scopes:
    # "all" | "none" | comma list from {layer1..layer4, decoder}; selective
    # remat keeps the FLOP-heavy small-activation layers in memory and
    # recomputes only the big stem-/half-res activations
    noise_rng: str = "threefry"          # augmentation noise epsilon source:
    # "threefry" (per-sample counter RNG, stream-stable) or "rbg" (one
    # hoisted XLA RngBitGenerator draw per batch; stream not stable across
    # backends/versions)
    grad_accum: int = 1                  # gradient-accumulation microbatches
    # per step (reg strategy): batch_size stays the EFFECTIVE per-chip
    # batch (reference CLI semantics, train.py:42) but the compiled
    # program only ever holds batch_size/grad_accum samples (lax.scan) —
    # how batches beyond what fits in device memory run

    @property
    def exp_name(self):
        return f"subtyping_{self.model_arch}"

    @property
    def exp_path(self) -> Path:
        return Path(self.model_path) / self.exp_name

    @property
    def is_regression(self):
        return "dram" in self.model_arch or "reg" in self.model_arch


class SubtypeTrainer:
    """Explicit trainer for both strategies (CLS / dRAM regression)."""

    def __init__(self, config: TrainerConfig, mesh=None):
        self.config = config
        if mesh is None:
            from ..parallel.mesh import MeshSpec
            from ..utils.cli import parse_mesh
            spec = parse_mesh(config.mesh)
            if spec is None:
                n = config.nchips or len(jax.devices())
                spec = MeshSpec(data=n)
            if spec.size > len(jax.devices()):
                raise ValueError(f"mesh {spec} needs {spec.size} devices, "
                                 f"only {len(jax.devices())} available")
            mesh = get_mesh(spec, devices=jax.devices()[:spec.size])
        self.mesh = mesh
        dtype = jnp.bfloat16 if config.compute_dtype == "bfloat16" else None
        # remat: recompute block activations in the backward pass instead
        # of keeping them in device memory
        self.model = get_model_by_name(config.model_arch, dtype=dtype,
                                       remat=config.remat)
        self.mode = "reg" if config.is_regression else "cls"
        self.tx = make_optimizer()
        n_data = self.mesh.shape["data"]
        fused = config.input_pipeline == "device"
        # trace-time setting: must precede make_*_train_step
        from ..transforms.batch_augment import set_noise_rng
        set_noise_rng(config.noise_rng)
        make = make_reg_train_step if self.mode == "reg" else make_cls_train_step
        step_kwargs = dict(fused_input=fused,
                           target_size=tuple(config.target_size),
                           donate=True)
        if config.grad_accum > 1:
            if config.batch_size % config.grad_accum:
                raise ValueError(
                    f"batch_size {config.batch_size} must divide by "
                    f"grad_accum {config.grad_accum}")
            step_kwargs["accum_steps"] = config.grad_accum
        self._train_step = make(self.model, self.tx, n_data, **step_kwargs)
        self._eval_step = make_eval_step(self.model, self.mode)
        self._predict_step = make_predict_step(self.model)
        self.state: Optional[TrainState] = None
        self.datasets: Dict[str, Any] = {}
        self.cle_class_weights = np.ones(6) / 6
        self.pse_class_weights = np.ones(3) / 3
        self.epoch = 0
        self.ckpt: Optional[CheckpointManager] = None
        self._tb = None
        self.epoch_train_losses: Dict[int, float] = {}
        self.global_step = 0

    @property
    def tb_writer(self):
        """Lazy TensorBoard writer on process 0 (parity with the reference's
        ``TensorBoardLogger`` in ``tb_logs/``, ``utils.py:261-263``)."""
        if self._tb is None and jax.process_index() == 0:
            try:
                from flax.metrics import tensorboard
                self._tb = tensorboard.SummaryWriter(
                    str(self.config.exp_path / "tb_logs"))
            except Exception as exc:  # tensorboard optional
                logger.warning("tensorboard unavailable: %s", exc)
                self._tb = False
        return self._tb or None

    # ------------------------------------------------------------------ setup
    def init_state(self, example_batch: Optional[Dict[str, np.ndarray]] = None):
        cfg = self.config
        if example_batch is None:
            shape = (1, *cfg.target_size)
            example_batch = {"image": np.zeros(shape, np.float32),
                             "lung_mask": np.ones(shape, np.float32)}
        x = jnp.asarray(example_batch["image"])[..., None]
        lungs = jnp.asarray(example_batch["lung_mask"])[..., None]
        variables = self.model.init(jax.random.PRNGKey(cfg.seed), x, lungs,
                                    train=False)
        self.state = self._place_state(TrainState.create(dict(variables),
                                                         self.tx))
        return self.state

    def _place_state(self, state: TrainState) -> TrainState:
        """Tensor-parallel parameter placement when the mesh has a 'model'
        extent (conv output channels sharded; XLA inserts the activation
        collectives).  No-op on pure data/spatial meshes."""
        if self.mesh.shape.get("model", 1) > 1:
            from ..parallel.mesh import shard_params_tp
            return shard_params_tp(self.mesh, state)
        return state

    def setup_checkpointing(self):
        self.ckpt = CheckpointManager(self.config.exp_path / "checkpoints")
        return self.ckpt

    def try_resume(self, reload_only_weights: bool = True,
                   ckp: Optional[str] = None) -> bool:
        """Auto-resume semantics of ``train.py:77-91``."""
        assert self.state is not None and self.ckpt is not None
        if ckp is not None and Path(ckp).suffix in (".ckpt", ".pth", ".pt",
                                                    ".npz"):
            new_vars = greedy_restore_variables(self.state.variables, ckp)
            self.state = self._place_state(self.state.replace(
                params=new_vars["params"],
                batch_stats=new_vars.get("batch_stats",
                                         self.state.batch_stats)))
            return True
        latest = self.ckpt.latest_epoch()
        if latest is None:
            return False
        state, extras, epoch = self.ckpt.restore(self.state, epoch=None)
        if reload_only_weights:
            self.state = self._place_state(self.state.replace(
                params=state.params, batch_stats=state.batch_stats))
        else:
            self.state = self._place_state(state)
            self.epoch = epoch + 1
            if extras.get("cle_class_weights") is not None:
                self.cle_class_weights = np.asarray(
                    extras["cle_class_weights"])
                self.pse_class_weights = np.asarray(
                    extras["pse_class_weights"])
        logger.info("resumed from epoch %d (weights_only=%s)", epoch,
                    reload_only_weights)
        return True

    def _dataset(self, phase: str):
        cfg = self.config
        if phase in self.datasets:
            return self.datasets[phase]
        csv_file = {TRAIN_PHASE: cfg.train_csv, VALID_PHASE: cfg.valid_csv,
                    TEST_PHASE: cfg.test_csv}[phase]
        ds = COPDGeneSubtyping(cfg.data_path,
                               COPDGeneSubtyping.get_series_uids(csv_file))
        self.datasets[phase] = ds
        if phase == TRAIN_PHASE:
            sampler = SubtypingStratifiedSampler(ds, cfg.num_samples,
                                                 seed=cfg.sampler_seed)
            self.sampler = sampler
            self.cle_class_weights = np.asarray(sampler.cle_class_weights)
            self.pse_class_weights = np.asarray(sampler.pse_class_weights)
            ds.cle_class_weights = self.cle_class_weights
            ds.pse_class_weights = self.pse_class_weights
            ds.cle_statistics = sampler.cle_statistics
            ds.pse_statistics = sampler.pse_statistics
        return ds

    @property
    def global_batch_size(self) -> int:
        """``batch_size`` per chip on the data axis across ALL processes —
        the reference's per-GPU batch semantics (``train.py:42`` x
        ``--ngpus``)."""
        return self.config.batch_size * self.mesh.shape["data"]

    @property
    def local_batch_size(self) -> int:
        """Per-process sub-batch: each process loads only the slice its own
        devices hold; ``shard_batch`` assembles the global array from the
        per-process pieces (the DDP loader contract)."""
        n_proc = jax.process_count()
        gbs = self.global_batch_size
        if gbs % n_proc:
            raise ValueError(f"global batch {gbs} must divide over "
                             f"{n_proc} processes")
        return gbs // n_proc

    def _loader(self, phase: str, epoch: int,
                input_pipeline: Optional[str] = None) -> DataLoader:
        cfg = self.config
        ds = self._dataset(phase)
        pipeline = input_pipeline or cfg.input_pipeline
        if pipeline == "device":
            from ..data.host_preprocess import RawPaddedView
            if cfg.pad_shape is None:
                raise ValueError("input_pipeline='device' needs pad_shape")
            view = RawPaddedView(ds, cfg.pad_shape)
        else:
            view = PreprocessedView(ds, cfg.target_size)
        lbs = self.local_batch_size
        if phase == TRAIN_PHASE:
            indices = list(iter(self.sampler))
            indices = shard_indices(indices, jax.process_count(),
                                    jax.process_index(), shuffle=True,
                                    epoch=epoch)
            return DataLoader(view, indices=indices, batch_size=lbs,
                              drop_last=True, num_workers=cfg.workers)
        indices = shard_indices(list(range(len(ds))), jax.process_count(),
                                jax.process_index(), shuffle=False)
        # pad by wrap-around (tiling, so datasets smaller than one local
        # batch still fill it) — duplicates are removed at epoch end (the
        # DistributedSampler padding + dedup pattern, models.py:306-311)
        if len(indices) % lbs:
            total = int(np.ceil(len(indices) / lbs)) * lbs
            indices = np.resize(np.asarray(indices), total)
        return DataLoader(view, indices=indices, batch_size=lbs,
                          drop_last=False, num_workers=cfg.workers)

    # ------------------------------------------------------------------ train
    def fit(self):
        cfg = self.config
        if cfg.debug_nans:
            jax.config.update("jax_debug_nans", True)
        if self.state is None:
            self.init_state()
        if self.ckpt is None:
            self.setup_checkpointing()
        key = jax.random.PRNGKey(cfg.seed)
        for epoch in range(self.epoch, cfg.max_epochs):
            self.epoch = epoch
            t0 = time.time()
            if cfg.profile and epoch == 0:
                trace_dir = str(cfg.exp_path / "profile")
                with jax.profiler.trace(trace_dir):
                    metrics, outputs = self._run_train_epoch(epoch, key)
                logger.info("profiler trace written to %s", trace_dir)
            else:
                metrics, outputs = self._run_train_epoch(epoch, key)
            self._epoch_end(outputs, TRAIN_PHASE, epoch)
            logger.info("epoch %d done in %.1fs %s", epoch,
                        time.time() - t0,
                        {k: round(float(v), 4) for k, v in metrics.items()})
            if self.tb_writer:
                for k, v in metrics.items():
                    self.tb_writer.scalar(f"{TRAIN_PHASE}_{k}", float(v),
                                          epoch)
            self.ckpt.save(epoch, jax.device_get(self.state), extras={
                "cle_class_weights": np.asarray(self.cle_class_weights),
                "pse_class_weights": np.asarray(self.pse_class_weights),
            })
            self.epoch_train_losses[epoch] = float(metrics.get("loss", 0.0))
            if (epoch + 1) % cfg.check_val_every_n_epoch == 0 and cfg.valid_csv:
                self.evaluate(VALID_PHASE, epoch)
        return self.state

    def restore_best(self) -> int:
        """Restore the lowest-train-loss epoch's checkpoint — the reference's
        ``trainer.test(ckpt_path='best')`` with ``monitor='train_loss'``
        (``train.py:92-99,108``)."""
        if not self.epoch_train_losses:
            return self.epoch
        best = min(self.epoch_train_losses, key=self.epoch_train_losses.get)
        state, extras, _ = self.ckpt.restore(self.state, epoch=best)
        self.state = state
        logger.info("restored best epoch %d (train_loss=%.4f)", best,
                    self.epoch_train_losses[best])
        return best

    def _run_train_epoch(self, epoch: int, key) -> Tuple[Dict, List[Dict]]:
        cfg = self.config
        lr = jnp.asarray(epoch_lr(cfg.lr, epoch), jnp.float32)
        cw_cle = jnp.asarray(self.cle_class_weights, jnp.float32)
        cw_pse = jnp.asarray(self.pse_class_weights, jnp.float32)
        outputs: List[Dict[str, np.ndarray]] = []
        running: Dict[str, float] = {}
        n_steps = 0

        device_mode = self.config.input_pipeline == "device"

        def put(batch):
            if device_mode:
                payload = {
                    "image_raw": batch["image_raw"],
                    "lung_raw": batch["lung_raw"],
                    "in_sizes": batch["in_sizes"].astype(np.int32),
                }
            else:
                payload = {
                    "image": batch["image"].astype(np.float32),
                    "lung_mask": batch["lung_mask"].astype(np.float32),
                    "em_mask": batch["em_mask"].astype(np.float32),
                }
            payload["cls_label"] = batch["cls_label"].astype(np.int32)
            payload["pse_label"] = batch["pse_label"].astype(np.int32)
            return shard_batch(self.mesh, payload), batch

        from ..data.loader import prefetch_to_device
        for step_idx, (device_batch, batch) in enumerate(
                prefetch_to_device(self._loader(TRAIN_PHASE, epoch), put)):
            step_key = jax.random.fold_in(jax.random.fold_in(key, epoch),
                                          step_idx)
            self.state, metrics, preds = self._train_step(
                self.state, device_batch, lr, cw_cle, cw_pse, step_key)
            n_steps += 1
            self.global_step += 1
            tb = self.tb_writer
            for k, v in metrics.items():
                v = float(v)
                running[k] = running.get(k, 0.0) + v
                # per-step scalars, parity with the reference's
                # on_step=True logging (models.py:575-579)
                if tb:
                    tb.scalar(f"{TRAIN_PHASE}_{k}_step", v, self.global_step)
            out = {k: process_local_data(v) for k, v in preds.items()}
            out["index"] = np.asarray(batch["index"]).reshape(-1)
            outputs.append(out)
        return ({k: v / max(n_steps, 1) for k, v in running.items()},
                outputs)

    # ------------------------------------------------------------------- eval
    def evaluate(self, phase: str, epoch: Optional[int] = None,
                 input_pipeline: Optional[str] = None) -> Dict[str, float]:
        """Eval epoch.  ``input_pipeline`` defaults to the config's setting,
        so a device-pipeline training run serves val/test through the same
        fused on-device preprocess (the reference applies one transform
        chain to all phases, ``models.py:55-80``); pass ``'host'``/
        ``'device'`` to override per call."""
        cfg = self.config
        epoch = epoch if epoch is not None else self.epoch
        pipeline = input_pipeline or cfg.input_pipeline
        device_mode = pipeline == "device"
        eval_step = (self._eval_step_fused() if device_mode
                     else self._eval_step)
        outputs = []

        def put(batch):
            if device_mode:
                payload = {
                    "image_raw": batch["image_raw"],
                    "lung_raw": batch["lung_raw"],
                    "in_sizes": batch["in_sizes"].astype(np.int32),
                }
            else:
                payload = {
                    "image": batch["image"].astype(np.float32),
                    "lung_mask": batch["lung_mask"].astype(np.float32),
                }
            payload["cls_label"] = batch["cls_label"].astype(np.int32)
            payload["pse_label"] = batch["pse_label"].astype(np.int32)
            return shard_batch(self.mesh, payload), batch

        from ..data.loader import prefetch_to_device
        for batch_idx, (device_batch, batch) in enumerate(
                prefetch_to_device(
                    self._loader(phase, epoch, input_pipeline=pipeline),
                    put)):
            res = eval_step(self.state, device_batch)
            out = {k: process_local_data(v) for k, v in res.items()
                   if not k.startswith("dense")}
            out["index"] = np.asarray(batch["index"]).reshape(-1)
            outputs.append(out)
            # heatmap tiles: the reference draws rank 0's LOCAL batch
            # (models.py:266-272).  The dense maps are batch-sharded, so
            # each process can address exactly its local rows —
            # process_local_data extracts them (the same local-row ↔
            # host-batch correspondence the metrics path above relies on).
            # Multi-process draws require a batch-only sharding: under a
            # spatial/model mesh extent the dense maps are ALSO sharded
            # along H/channels, which process_local_data's axis-0 dedup
            # would silently truncate to one fragment per row
            batch_only = (jax.process_count() == 1
                          or (self.mesh.shape.get("spatial", 1) == 1
                              and self.mesh.shape.get("model", 1) == 1))
            if (jax.process_index() == 0 and batch_only
                    and batch_idx < cfg.debug_draw_batches):
                draw_batch = (self._host_view_of_raw_batch(batch)
                              if device_mode else batch)
                local_res = {k: process_local_data(v)
                             for k, v in res.items()}
                self._draw_predictions(draw_batch, local_res, phase, epoch)
        return self._epoch_end(outputs, phase, epoch)

    def _eval_step_fused(self):
        """Lazily-built eval step with the fused device preprocess (one
        extra jit program, only compiled when device-pipeline eval runs)."""
        if not hasattr(self, "_eval_step_fused_cached"):
            self._eval_step_fused_cached = make_eval_step(
                self.model, self.mode, fused_input=True,
                target_size=tuple(self.config.target_size))
        return self._eval_step_fused_cached

    def _host_view_of_raw_batch(self, batch) -> Dict[str, np.ndarray]:
        """Host-preprocess a raw padded batch for the heatmap artifacts
        (drawn batches only — the hot path stays fused on the device)."""
        from ..data.host_preprocess import preprocess_sample
        images, lungs, ems = [], [], []
        for i in range(len(batch["in_sizes"])):
            sl = tuple(slice(0, int(s)) for s in batch["in_sizes"][i])
            raw = np.asarray(batch["image_raw"][i])[sl]
            lung = np.asarray(batch["lung_raw"][i])[sl] > 0
            sample = {"image": raw, "lung_mask": lung,
                      "em_mask": np.logical_and(raw < -950, lung)}
            pre = preprocess_sample(sample, tuple(self.config.target_size))
            images.append(pre["image"])
            lungs.append(pre["lung_mask"])
            ems.append(pre["em_mask"])
        return {"image": np.stack(images), "lung_mask": np.stack(lungs),
                "em_mask": np.stack(ems), "index": batch["index"]}

    # --------------------------------------------------------------- epoch end
    def _epoch_end(self, outputs: List[Dict], phase: str, epoch: int
                   ) -> Dict[str, float]:
        """``shared_epoch_end`` (``models.py:287-317,603-633``): gather,
        dedup by dataset index, CM PNGs, CSV, accuracy, CLS reweighting."""
        if not outputs:
            return {}
        cat = {k: np.concatenate([o[k] for o in outputs]) for k in outputs[0]}
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils
            cat = {k: np.asarray(
                multihost_utils.process_allgather(v)).reshape(-1)
                for k, v in cat.items()}
        if jax.process_index() != 0:
            return {}
        acc_cle = float((cat["pred_cle_labels"] == cat["cle_labels"]).mean())
        acc_pse = float((cat["pred_pse_labels"] == cat["pse_labels"]).mean())
        _, unique_ids = np.unique(cat["index"], return_index=True)
        dedup = {k: v[unique_ids] for k, v in cat.items()}
        from ..utils.metrics_eval import classification_report
        report = classification_report(dedup["cle_labels"],
                                       dedup["pred_cle_labels"], 6,
                                       prefix=f"epoch_{phase}_cle_")
        report.update(classification_report(dedup["pse_labels"],
                                            dedup["pred_pse_labels"], 3,
                                            prefix=f"epoch_{phase}_pse_"))
        self._log_confusion_matrix(dedup["pred_cle_labels"],
                                   dedup["cle_labels"], phase, "cle", 6,
                                   epoch)
        self._log_confusion_matrix(dedup["pred_pse_labels"],
                                   dedup["pse_labels"], phase, "pse", 3,
                                   epoch)
        self._log_csv(dedup, phase, epoch)
        logger.info("epoch_%s_acc_cle=%.4f acc_pse=%.4f", phase, acc_cle,
                    acc_pse)
        metrics = {f"epoch_{phase}_acc_cle": acc_cle,
                   f"epoch_{phase}_acc_pse": acc_pse, **report}
        self._append_metrics_log(phase, epoch, metrics)
        if self.tb_writer:
            for k, v in metrics.items():
                self.tb_writer.scalar(k, v, epoch)
        return metrics

    def _log_confusion_matrix(self, y_pred, y_true, phase, name, n_classes,
                              epoch):
        try:
            plt_obj = plot_confusion_matrix_from_data(
                y_true, y_pred, list(range(n_classes)), line_width=0.5,
                fig_size=10, font_size=11)
        except ImportError as exc:  # the plot needs matplotlib + seaborn
            logger.warning("confusion-matrix PNG skipped: %s", exc)
        else:
            image = plot_to_numpy_array(plt_obj)
            out_dir = self.config.exp_path / "confusion_matrices" / phase
            out_dir.mkdir(parents=True, exist_ok=True)
            save_image(out_dir / f"{phase}_epoch_{epoch}_cm_{name}.png",
                       image)
            if self.tb_writer:
                self.tb_writer.image(f"{phase}_confusion_matrix_{name}",
                                     image, epoch)
        # adaptive class re-weighting: CLS strategy, training phase only
        # (models.py:369-379)
        if phase == TRAIN_PHASE and self.mode == "cls":
            matrix = np.zeros((n_classes, n_classes))
            for t, p in zip(y_true.astype(int), y_pred.astype(int)):
                matrix[t, p] += 1
            with np.errstate(invalid="ignore", divide="ignore"):
                per_class_acc = np.nan_to_num(
                    matrix.diagonal() / matrix.sum(axis=1))
            current = np.asarray(getattr(self, f"{name}_class_weights"))
            if len(per_class_acc) == len(current):
                new = current * (1.0 - per_class_acc)
                total = new.sum()
                if total > 0:
                    new = new / total
                    setattr(self, f"{name}_class_weights", new)
                    logger.info("reset %s class weights: %s -> %s", name,
                                current, new)

    def _log_csv(self, dedup: Dict[str, np.ndarray], phase: str, epoch: int):
        ds = self.datasets.get(phase)
        uids = ([ds.series_uids[i] for i in dedup["index"]]
                if ds is not None else list(map(str, dedup["index"])))
        out_dir = self.config.exp_path / "predicts" / phase
        out_dir.mkdir(parents=True, exist_ok=True)
        with open(out_dir / f"{epoch}_predicts.csv", "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["uid", "y_preds_cle", "y_preds_pse", "y_cle",
                             "y_pse"])
            for row in zip(uids, dedup["pred_cle_labels"],
                           dedup["pred_pse_labels"], dedup["cle_labels"],
                           dedup["pse_labels"]):
                writer.writerow(row)

    def _append_metrics_log(self, phase, epoch, metrics: Dict[str, float]):
        out = self.config.exp_path / "metrics.jsonl"
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "a") as f:
            f.write(json.dumps({"epoch": epoch, "phase": phase, **metrics})
                    + "\n")

    def _draw_predictions(self, batch, res, phase, epoch):
        """First-batches heatmap tiles (``models.py:455-493``)."""
        from ..ops.resize import resize_linear
        out_dir = (self.config.exp_path / "debug_input_data" / str(epoch)
                   / phase)
        out_dir.mkdir(parents=True, exist_ok=True)
        size = batch["image"].shape[1:4]
        dense_cle = np.asarray(resize_linear(res["dense_cle"], size, (1, 2, 3),
                                             align_corners=False))
        dense_pse = np.asarray(resize_linear(res["dense_pse"], size, (1, 2, 3),
                                             align_corners=False))
        ds = self.datasets.get(phase)
        for i in range(batch["image"].shape[0]):
            scan = np.asarray(batch["image"][i])
            lung = np.asarray(batch["lung_mask"][i])
            em = np.asarray(batch.get("em_mask", np.zeros_like(lung))[i])
            if self.mode == "reg":
                dp_cle = dense_cle[i, ..., 0]
                dp_pse = dense_pse[i, ..., 0]
            else:
                dp_cle = np.maximum(dense_cle[i, ..., 1:], 0).sum(-1)
                dp_pse = np.maximum(dense_pse[i, ..., 1:], 0).sum(-1)
                dp_cle = dp_cle / (dp_cle.max() + 1e-7)
                dp_pse = dp_pse / (dp_pse.max() + 1e-7)
            index = int(np.asarray(batch["index"]).reshape(-1)[i])
            uid = ds.series_uids[index] if ds is not None else str(index)
            cle_l = int(np.asarray(res["cle_labels"])[i])
            pse_l = int(np.asarray(res["pse_labels"])[i])
            p_cle = int(np.asarray(res["pred_cle_labels"])[i])
            p_pse = int(np.asarray(res["pred_pse_labels"])[i])
            path = out_dir / (f"{uid}_label_{cle_l}_{p_cle}_{pse_l}_{p_pse}")
            draw_mask_tile_singleview_heatmap(
                windowing(scan, from_span=None).astype(np.uint8),
                [[(lung * 255).astype(np.uint8)],
                 [windowing(dp_cle * lung, from_span=(0, 1)).astype(np.uint8)],
                 [windowing(dp_pse * lung, from_span=(0, 1)).astype(np.uint8)],
                 [(em * 255).astype(np.uint8)]],
                lung > 0, 5, path, coord_axis=0,
                titles=["lung", "heatmap (cle)", "heatmap (pse)", "LAA950"])

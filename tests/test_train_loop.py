"""End-to-end training-system tests over a synthetic archive (CPU mesh)."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bodyct_dram_emph_subtype.train import (
    SubtypeTrainer,
    TrainerConfig,
    epoch_lr,
)
from tests.test_data import make_training_archive


@pytest.fixture
def archive(tmp_path):
    make_training_archive(tmp_path, n=24, shape=(16, 20, 24))
    return tmp_path


def _config(archive, tmp_path, arch, **kw):
    csv = str(archive / "merged.csv")
    defaults = dict(
        model_arch=arch, lr=1e-3, max_epochs=2, batch_size=2, num_samples=2,
        target_size=(16, 24, 32), workers=2, data_path=str(archive),
        train_csv=csv, valid_csv=csv, test_csv=csv, nchips=2,
        model_path=str(tmp_path / "models"), sampler_seed=0,
        debug_draw_batches=1)
    defaults.update(kw)
    return TrainerConfig(**defaults)


def test_epoch_lr_schedule():
    assert epoch_lr(1e-4, 0) == 1e-4
    np.testing.assert_allclose(epoch_lr(1e-4, 10), 1e-4 * 0.95 ** 10)


@pytest.mark.slow
def test_reg_training_runs_and_checkpoints(archive, tmp_path):
    cfg = _config(archive, tmp_path, "med3ddramtiny")
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    p0 = jax.device_get(trainer.state.params)
    trainer.fit()
    # params actually moved
    p1 = jax.device_get(trainer.state.params)
    diffs = jax.tree.map(lambda a, b: float(np.abs(a - b).max()), p0, p1)
    assert max(jax.tree.leaves(diffs)) > 0
    # artifacts: checkpoints for both epochs, CMs, CSVs, metrics log
    ckpt_dir = cfg.exp_path / "checkpoints"
    assert trainer.ckpt.latest_epoch() == 1
    assert (cfg.exp_path / "confusion_matrices" / "train").exists()
    csvs = list((cfg.exp_path / "predicts" / "train").glob("*_predicts.csv"))
    assert len(csvs) == 2
    lines = (cfg.exp_path / "metrics.jsonl").read_text().strip().splitlines()
    entries = [json.loads(l) for l in lines]
    assert any(e["phase"] == "validate" for e in entries)
    # heatmap tiles drawn for the first eval batch
    tiles = list((cfg.exp_path / "debug_input_data").rglob("*.jpg"))
    assert tiles


def test_reg_training_resume(archive, tmp_path):
    cfg = _config(archive, tmp_path, "med3ddramtiny", max_epochs=1)
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.setup_checkpointing()
    assert not trainer.try_resume()   # nothing yet
    trainer.fit()

    cfg2 = _config(archive, tmp_path, "med3ddramtiny", max_epochs=2)
    trainer2 = SubtypeTrainer(cfg2)
    trainer2.init_state()
    trainer2.setup_checkpointing()
    assert trainer2.try_resume(reload_only_weights=False)
    assert trainer2.epoch == 1   # resumes *after* the saved epoch
    np.testing.assert_allclose(
        np.asarray(jax.tree.leaves(trainer2.state.params)[0]),
        np.asarray(jax.tree.leaves(trainer.state.params)[0]))


@pytest.mark.slow
def test_cls_training_adaptive_reweighting(archive, tmp_path):
    cfg = _config(archive, tmp_path, "med3dtiny")
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    w_before = np.asarray(trainer.cle_class_weights).copy()
    trainer.fit()
    w_after = np.asarray(trainer.cle_class_weights)
    # weights were renormalised by the adaptive update
    np.testing.assert_allclose(w_after.sum(), 1.0, atol=1e-6)
    assert not np.allclose(w_before, w_after)


@pytest.mark.slow
def test_device_input_pipeline_trains(archive, tmp_path):
    """input_pipeline='device': loader ships raw padded int16; window/
    standardize/resize/LAA all run fused inside the train step."""
    cfg = _config(archive, tmp_path, "med3ddramtiny", max_epochs=1,
                  input_pipeline="device", pad_shape=(16, 20, 24))
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.fit()
    lines = (cfg.exp_path / "metrics.jsonl").read_text().strip().splitlines()
    entries = [json.loads(l) for l in lines]
    assert any(e["phase"] == "train" for e in entries)


def test_device_pipeline_eval_matches_host(archive, tmp_path):
    """``evaluate(input_pipeline='device')`` serves val/test through the
    fused on-device preprocess — the same chain the train phase uses (the
    reference applies one transform chain to all phases,
    ``models.py:55-80``)."""
    cfg = _config(archive, tmp_path, "med3ddramtiny", max_epochs=1,
                  pad_shape=(16, 20, 24))
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    m_host = trainer.evaluate("test", epoch=0, input_pipeline="host")
    m_dev = trainer.evaluate("test", epoch=0, input_pipeline="device")
    # device preprocess tracks the torch-parity host path to ~1e-3 on the
    # lung percentages; on 24 scans allow a couple of threshold flips
    np.testing.assert_allclose(m_dev["epoch_test_acc_cle"],
                               m_host["epoch_test_acc_cle"], atol=0.13)
    np.testing.assert_allclose(m_dev["epoch_test_acc_pse"],
                               m_host["epoch_test_acc_pse"], atol=0.13)
    # the draw path host-preprocesses the raw batch for the tiles
    tiles = list((cfg.exp_path / "debug_input_data").rglob("*.jpg"))
    assert tiles


@pytest.mark.slow
def test_cli_spatial_mesh_epoch(archive, tmp_path):
    """``train.py --mesh data=2,spatial=2`` runs a full (tiny) epoch on the
    virtual CPU mesh: the beyond-reference mesh axes are reachable from the
    CLI, not just library code."""
    repo = Path(__file__).resolve().parents[1]
    csv = str(archive / "merged.csv")
    out = subprocess.run(
        [sys.executable, str(repo / "train.py"),
         "--model_arch", "med3ddramtiny", "--mesh", "data=2,spatial=2",
         "--batch_size", "1", "--num_samples", "2", "--max_epochs", "1",
         "--target_size", "16,24,32", "--workers", "2",
         "--data_path", str(archive), "--train_csv", csv,
         "--valid_csv", csv, "--test_csv", csv,
         "--model_path", str(tmp_path / "models")],
        capture_output=True, text=True)
    assert out.returncode == 0, (out.stdout[-1000:], out.stderr[-3000:])
    logs = list((tmp_path / "models").rglob("metrics.jsonl"))
    assert logs, "no metrics.jsonl produced"
    entries = [json.loads(l)
               for l in logs[0].read_text().strip().splitlines()]
    assert any(e["phase"] == "train" for e in entries)
    assert any(e["phase"] == "test" for e in entries)


def test_evaluate_produces_metrics(archive, tmp_path):
    cfg = _config(archive, tmp_path, "med3ddramtiny", max_epochs=1)
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    metrics = trainer.evaluate("test", epoch=0)
    assert 0.0 <= metrics["epoch_test_acc_cle"] <= 1.0
    assert 0.0 <= metrics["epoch_test_acc_pse"] <= 1.0


def test_grad_accum_matches_single_step_on_repeated_microbatch():
    """Gradient accumulation (``make_reg_train_step(accum_steps=2)``):
    a batch made of two IDENTICAL microbatches must produce exactly the
    parameter update of one plain step on a single microbatch (grad-mean
    of equal grads == the grad; per-microbatch BN stats equal too), and
    stack the per-microbatch predictions back to full batch order."""
    from bodyct_dram_emph_subtype.models.resnet3d import ResNetSegReg
    from bodyct_dram_emph_subtype.train import (
        TrainState, make_optimizer, make_reg_train_step)

    import optax

    rng = np.random.RandomState(0)
    shape = (8, 16, 16)
    model = ResNetSegReg(layers=(1, 1, 1, 1))
    x0 = jnp.zeros((1, *shape, 1), jnp.float32)
    v = model.init(jax.random.PRNGKey(0), x0, x0, train=False)
    # identity transform (plain SGD): the update is LINEAR in the grads, so
    # param deltas compare the accumulated grad directly.  Adam's first
    # step is ~lr*sign(g) — any float-reassociation difference between the
    # scanned and unscanned programs flips near-zero grads by 2*lr
    # (PARITY.md, numerical notes), which would test XLA fusion, not accum math.
    tx = optax.identity()
    state = TrainState.create(dict(v), tx)

    micro = {
        "image": rng.randn(2, *shape).astype(np.float32),
        "lung_mask": np.ones((2, *shape), np.float32),
        "em_mask": (rng.rand(2, *shape) > 0.8).astype(np.float32),
        "cls_label": np.asarray([1, 3], np.int32),
        "pse_label": np.asarray([0, 2], np.int32),
    }
    full = {k: np.concatenate([v, v]) for k, v in micro.items()}
    args = (jnp.asarray(1e-3), jnp.ones(6, jnp.float32) / 6,
            jnp.ones(3, jnp.float32) / 3, jax.random.PRNGKey(7))

    # augment=False so both microbatches see identical inputs (the accum
    # path folds a distinct key per microbatch by design)
    step1 = make_reg_train_step(model, tx, augment=False)
    s1, m1, p1 = step1(state, micro, *args)

    step2 = make_reg_train_step(model, tx, augment=False, accum_steps=2)
    s2, m2, p2 = step2(state, full, *args)

    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    for p0, a, b in zip(jax.tree.leaves(jax.device_get(state.params)),
                        jax.tree.leaves(jax.device_get(s2.params)),
                        jax.tree.leaves(jax.device_get(s1.params))):
        # compare the param DELTAS (= -lr * grad under optax.identity)
        np.testing.assert_allclose(np.asarray(a) - np.asarray(p0),
                                   np.asarray(b) - np.asarray(p0),
                                   rtol=1e-4, atol=1e-7)
    # predictions restore full batch order (microbatch-major)
    assert np.asarray(p2["cle_labels"]).tolist() == [1, 3, 1, 3]
    assert np.asarray(p2["pred_cle_labels"]).shape == (4,)
    # BN running stats: two identical chained updates == applying the
    # momentum update twice; just require finiteness + movement here
    stats2 = jax.tree.leaves(jax.device_get(s2.batch_stats))
    assert all(np.isfinite(s).all() for s in stats2)


def test_cls_grad_accum_matches_single_step_on_repeated_microbatch():
    """CLS accumulation (``make_cls_train_step(accum_steps=2)``): same
    equivalence as the reg test — two identical microbatches == one plain
    step (reference scales the CLS batch freely on GPU, ``train.py:42``)."""
    from bodyct_dram_emph_subtype.models.resnet3d import ResNetSegCls
    from bodyct_dram_emph_subtype.train import (
        TrainState, make_cls_train_step)

    import optax

    rng = np.random.RandomState(1)
    shape = (8, 16, 16)
    model = ResNetSegCls(layers=(1, 1, 1, 1), n_classes=(6, 3))
    x0 = jnp.zeros((1, *shape, 1), jnp.float32)
    v = model.init(jax.random.PRNGKey(0), x0, x0, train=False)
    tx = optax.identity()
    state = TrainState.create(dict(v), tx)

    micro = {
        "image": rng.randn(2, *shape).astype(np.float32),
        "lung_mask": np.ones((2, *shape), np.float32),
        "em_mask": (rng.rand(2, *shape) > 0.8).astype(np.float32),
        "cls_label": np.asarray([2, 5], np.int32),
        "pse_label": np.asarray([1, 0], np.int32),
    }
    full = {k: np.concatenate([v, v]) for k, v in micro.items()}
    args = (jnp.asarray(1e-3), jnp.ones(6, jnp.float32) / 6,
            jnp.ones(3, jnp.float32) / 3, jax.random.PRNGKey(7))

    step1 = make_cls_train_step(model, tx, augment=False)
    s1, m1, p1 = step1(state, micro, *args)

    step2 = make_cls_train_step(model, tx, augment=False, accum_steps=2)
    s2, m2, p2 = step2(state, full, *args)

    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    for p0, a, b in zip(jax.tree.leaves(jax.device_get(state.params)),
                        jax.tree.leaves(jax.device_get(s2.params)),
                        jax.tree.leaves(jax.device_get(s1.params))):
        # atol 3e-7: the scanned vs unscanned programs fuse differently,
        # so individual grad elements can drift by a couple of f32 ulps
        np.testing.assert_allclose(np.asarray(a) - np.asarray(p0),
                                   np.asarray(b) - np.asarray(p0),
                                   rtol=1e-4, atol=3e-7)
    assert np.asarray(p2["cle_labels"]).tolist() == [2, 5, 2, 5]
    assert np.asarray(p2["pred_cle_labels"]).shape == (4,)
    stats2 = jax.tree.leaves(jax.device_get(s2.batch_stats))
    assert all(np.isfinite(s).all() for s in stats2)

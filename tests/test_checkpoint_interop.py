"""Checkpoint interop: torch→npz→greedy restore, processor loading of a
train checkpoint directory, best-epoch restore."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bodyct_dram_emph_subtype.models import get_model_by_name
from bodyct_dram_emph_subtype.train import (
    CheckpointManager,
    TrainState,
    greedy_restore_variables,
    make_optimizer,
)

REPO = Path(__file__).resolve().parents[1]
REFERENCE = Path("/root/reference")


@pytest.mark.skipif(not REFERENCE.exists(), reason="reference not mounted")
def test_torch_ckpt_to_npz_roundtrip(tmp_path):
    """torch model → saved .ckpt → tool-converted .npz → greedy restore;
    the restored forward must equal direct torch-state restoration."""
    import torch

    sys.path.insert(0, str(REFERENCE))
    try:
        import med3d as ref_med3d
        torch_model = ref_med3d.resnet18segreg().eval()
    finally:
        sys.path.pop(0)
    ckpt = tmp_path / "weights.ckpt"
    torch.save({"state_dict": torch_model.state_dict(), "epoch": 7}, ckpt)

    npz = tmp_path / "weights.npz"
    subprocess.run([sys.executable, str(REPO / "tools/convert_checkpoint.py"),
                    "--src", str(ckpt), "--to_npz", str(npz)],
                   check=True, capture_output=True)

    model = get_model_by_name("med3ddramtiny")
    x = jnp.zeros((1, 16, 32, 32, 1), jnp.float32)
    variables = dict(model.init(jax.random.PRNGKey(0), x, x, train=False))
    from_ckpt = greedy_restore_variables(dict(variables), str(ckpt))
    from_npz = greedy_restore_variables(dict(variables), str(npz))
    for a, b in zip(jax.tree.leaves(from_ckpt["params"]),
                    jax.tree.leaves(from_npz["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_processor_loads_orbax_dir(tmp_path):
    """run_inference accepts a train checkpoint directory (train→deploy)."""
    from bodyct_dram_emph_subtype.inference import run_inference
    from tests.test_processor import _write_case

    model = get_model_by_name("med3ddramtiny")
    x = jnp.zeros((1, 16, 32, 32, 1), jnp.float32)
    variables = dict(model.init(jax.random.PRNGKey(3), x, x, train=False))
    state = TrainState.create(variables, make_optimizer())
    ckpt_dir = tmp_path / "ckpts"
    CheckpointManager(ckpt_dir).save(0, state)

    scan_dir = tmp_path / "ct"
    lobe_dir = tmp_path / "lobes"
    out_dir = tmp_path / "out"
    scan_dir.mkdir(); lobe_dir.mkdir(); out_dir.mkdir()
    _write_case(scan_dir, lobe_dir, "c1", shape=(40, 56, 72))
    results = run_inference(str(scan_dir), str(lobe_dir), str(out_dir),
                            model_arch="med3ddramtiny",
                            ckp_path=str(ckpt_dir),
                            target_size=(32, 48, 64), batch_size=1,
                            workers=1, nchips=1)
    assert results[0]["entity"] == "c1"


def test_restore_best_picks_lowest_loss(tmp_path):
    from bodyct_dram_emph_subtype.train import SubtypeTrainer, TrainerConfig
    cfg = TrainerConfig(model_arch="med3ddramtiny", model_path=str(tmp_path),
                        target_size=(16, 24, 32), nchips=1)
    trainer = SubtypeTrainer(cfg)
    trainer.init_state()
    trainer.setup_checkpointing()
    # fabricate three epochs with different losses
    for epoch, loss in ((0, 5.0), (1, 2.0), (2, 3.0)):
        trainer.state = trainer.state.replace(
            step=jnp.asarray(epoch + 100, jnp.int32))
        trainer.ckpt.save(epoch, jax.device_get(trainer.state))
        trainer.epoch_train_losses[epoch] = loss
    best = trainer.restore_best()
    assert best == 1
    assert int(trainer.state.step) == 101

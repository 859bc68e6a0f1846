"""``chip_smoke.py`` phase functions at tiny size on the CPU, called
directly (the script's ``main`` needs a GPU), and its GPU-only parity
check."""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

TINY_SCANS = dict(arch="med3ddramtiny", scan_shape=(40, 64, 96),
                  lung_radii=(12, 14, 20), target_size=(32, 48, 64),
                  pad_shape=(40, 56, 72), workers=1)


def test_processor_phase_tiny(tmp_path):
    """Device-preprocess bf16 runs, the oversized scan's host fallback, the
    output contract and the bf16-vs-float32 percentage check."""
    report = chip_smoke.processor_phase(
        tmp_path, n_scans=2, oversized_radii=(12, 14, 30), batch_size=1,
        **TINY_SCANS)
    assert report["scans"] == 3
    assert report["max_pct_diff"] <= chip_smoke.PCT_ATOL_BF16


def test_check_outputs_rejects_missing_heatmap(tmp_path):
    from bodyct_dram_emph_subtype.inference import run_inference

    scan_dir, lobe_dir, uids = chip_smoke.make_scans(
        tmp_path / "in", 1, (40, 64, 96), (12, 14, 20))
    out = tmp_path / "out"
    results = run_inference(str(scan_dir), str(lobe_dir), str(out),
                            model_arch="med3ddramtiny", ckp_path=None,
                            target_size=(32, 48, 64), pad_shape=(40, 56, 72),
                            batch_size=1, workers=1, nchips=1)
    chip_smoke.check_outputs(out, results, uids, (40, 64, 96))
    (out / "images" / "paraseptal-emphysema-heatmap"
     / f"{uids[0]}.mha").unlink()
    with pytest.raises(FileNotFoundError):
        chip_smoke.check_outputs(out, results, uids, (40, 64, 96))


def test_parity_phase_tiny_cpu():
    """The card-vs-host comparison code, run between two CPU devices."""
    report = chip_smoke.parity_phase(arch="med3ddramtiny",
                                     shape=(2, 16, 32, 32),
                                     device=jax.devices()[1])
    assert np.isfinite(report["loss_cpu"])
    np.testing.assert_allclose(report["loss_gpu"], report["loss_cpu"],
                               rtol=chip_smoke.PARITY_RTOL)


@pytest.mark.gpu
def test_parity_phase_on_gpu(gpu):
    """The card against the host CPU backend, float32 at precision
    highest."""
    report = chip_smoke.parity_phase(arch="med3ddramtiny",
                                     shape=(2, 16, 32, 32), device=gpu)
    assert report["grad_cos"] >= chip_smoke.GRAD_COS

"""``chip_smoke.py`` train phase and the four-card phases at tiny size: the
four-card data-parallel comparisons run on 4 virtual CPU devices."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


def test_train_phase_tiny(tmp_path):
    """Short epoch + eval + checkpoint + resume through SubtypeTrainer on
    the device input pipeline, then the timed step program."""
    report = chip_smoke.train_phase(
        tmp_path, arch="med3ddramtiny", raw_shape=(20, 28, 36),
        pad_shape=(24, 32, 40), target_size=(16, 24, 32), batch_size=2,
        n_series=6, num_samples=1, workers=1, timed_steps=1)
    assert report["steps"] == 3


def test_dp_train_phase_four_virtual_devices():
    report = chip_smoke.dp_train_phase(arch="med3ddramtiny",
                                       shape=(4, 16, 32, 32), cards=4,
                                       grad_shape=(4, 16, 32, 32))
    assert abs(report["loss_dp"] - report["loss_1"]) <= (
        chip_smoke.DP_LOSS_RTOL * abs(report["loss_1"]))


def test_dp_processor_phase_four_virtual_devices(tmp_path):
    report = chip_smoke.dp_processor_phase(
        tmp_path, cards=4, **chip_smoke_tiny())
    assert report["max_pct_diff"] <= chip_smoke.DP_PCT_ATOL


def chip_smoke_tiny():
    return dict(arch="med3ddramtiny", scan_shape=(40, 64, 96),
                lung_radii=(12, 14, 20), target_size=(32, 48, 64),
                pad_shape=(40, 56, 72), workers=1)

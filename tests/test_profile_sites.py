"""The trace → per-stage device time reduction of ``tools/profile_sites.py``
on a small trace recorded on the CPU backend."""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from tools import profile_sites  # noqa: E402


def test_reduction_attributes_time_to_model_stages(tmp_path):
    reports = profile_sites.profile(tmp_path, batch=1, size=(16, 32, 32),
                                    plane_prefix="/host:CPU",
                                    arch="med3ddramtiny")
    for name in ("eval_forward", "train_step"):
        dev = reports[name]["device_us_per_call"]
        stages = {k for k, v in dev.items() if v > 0} & set(
            profile_sites.SCOPES)
        assert {"stem", "layer1", "us2", "us3", "heads"} <= stages, dev
        assert dev["busy_us"] > 0
        assert sum(dev[s] for s in stages) <= 1.5 * sum(
            v for k, v in dev.items() if k != "busy_us")


def test_site_costs_and_roofline_bounds():
    costs = profile_sites.site_costs(4)
    flops, nbytes = costs["layer1"]
    # 6 convs of 64→64 at 32x56x72, B=4: 2·N·Cout·Cin·27 each
    assert flops == 6 * 2.0 * 4 * 32 * 56 * 72 * 64 * 64 * 27
    reports = {"eval_forward": {"device_us_per_call": {
        "layer1": 1000.0, "us2": 2000.0, "us3": 500.0, "maxpool": 300.0,
        "masked_pool": 50.0}}}
    sites = profile_sites.roofline(reports, "NVIDIA H100 80GB HBM3", 4,
                                   (128, 224, 288))
    assert sites["layer1"]["bound"] == "compute"
    assert sites["stem_maxpool"]["bound"] == "memory"
    assert 0 < sites["us3_conv"]["roofline_share"] < 1

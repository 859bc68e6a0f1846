"""Smoke tests for the repo tools + CLI helpers."""
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bodyct_dram_emph_subtype.data import COPDGeneSubtyping, write_mha
from bodyct_dram_emph_subtype.utils.cli import parse_size

REPO = Path(__file__).resolve().parents[1]


def test_parse_size():
    assert parse_size("(128,224,288)") == (128, 224, 288)
    assert parse_size("128,224,288") == (128, 224, 288)
    assert parse_size("128 224 288") == (128, 224, 288)
    assert parse_size((128, 224, 288)) == (128, 224, 288)
    with pytest.raises(ValueError):
        parse_size("abc")


def test_label_statistics_tool(tmp_path):
    csv = tmp_path / "labels.csv"
    csv.write_text("SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
                   "CT_Visual_Emph_Paraseptal_P1\n"
                   "a,0,0\nb,5,2\nc,5,1\n")
    out = subprocess.run(
        [sys.executable, str(REPO / "tools/compute_label_statistics.py"),
         "--csvs", str(csv)], capture_output=True, text=True, check=True)
    stats = json.loads(out.stdout.strip())
    assert stats["n"] == 3
    assert stats["cle_counts"]["5"] == 2
    assert stats["pse_counts"]["1"] == 1


def test_build_cache_from_mha(tmp_path):
    scan_dir = tmp_path / "ct"
    lobe_dir = tmp_path / "lobes"
    out_dir = tmp_path / "cache"
    scan_dir.mkdir()
    lobe_dir.mkdir()
    rng = np.random.RandomState(0)
    shape = (24, 30, 36)
    lobe = np.zeros(shape, np.uint8)
    lobe[4:20, 6:24, 8:30] = 1
    ct = np.full(shape, -600, np.int16)
    ct[lobe > 0] = (-880 + 60 * rng.randn((lobe > 0).sum())).astype(np.int16)
    write_mha(scan_dir / "u1.mha", ct, (0.7, 0.7, 2.0))
    write_mha(lobe_dir / "u1.mha", lobe, (0.7, 0.7, 2.0))
    labels = tmp_path / "labels.csv"
    labels.write_text("SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
                      "CT_Visual_Emph_Paraseptal_P1\nu1,3,1\n")
    subprocess.run(
        [sys.executable, str(REPO / "tools/build_cache.py"),
         "--scan_path", str(scan_dir), "--lobe_path", str(lobe_dir),
         "--labels_csv", str(labels), "--output_path", str(out_dir)],
        capture_output=True, text=True, check=True)
    # the cache round-trips through the training dataset
    ds = COPDGeneSubtyping(str(out_dir),
                           COPDGeneSubtyping.get_series_uids(
                               str(out_dir / "merged.csv")))
    item = ds[0]
    assert item["image"].dtype == np.int16
    assert int(item["cls_label"]) == 3 and int(item["pse_label"]) == 1
    assert item["em_mask"].shape == item["image"].shape


def test_complexity_external_baseline_table():
    """The reference-style MONAI-resnet comparison rows
    (``compute_computation_complexity_resnet.py:9-43``): analytic MACs of
    standard resnet18/34/50 at 224 in 2D and 3D.  The 2D figures must land
    on the published torchvision-convention values (resnet18 ~1.8 GMACs,
    resnet50 ~4.1)."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from tools.compute_computation_complexity import external_baseline_table

    rows = {r["arch"]: r for r in external_baseline_table()}
    assert len(rows) == 6
    assert abs(rows["resnet18_2d (baseline)"]["gmacs"] - 1.8) < 0.2
    assert abs(rows["resnet50_2d (baseline)"]["gmacs"] - 4.1) < 0.4
    # 3D at 224^3 is ~128x the 2D work for the stem alone; sanity-bound
    assert rows["resnet34_3d (baseline)"]["gmacs"] > 100
    for r in rows.values():
        assert r["params_M"] > 10

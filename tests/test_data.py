"""Data-layer tests: MHA codec roundtrip, datasets over synthetic fixtures,
stratified sampler statistics, index sharding."""
import numpy as np
import pytest

from bodyct_dram_emph_subtype.data import (
    COPDGeneSubtyping,
    DataLoader,
    SubtypingInference,
    SubtypingStratifiedSampler,
    balanced_class_weights,
    ratio_to_label,
    read_mha,
    shard_indices,
    write_mha,
)
from bodyct_dram_emph_subtype.data.datasets import CLE_RATIO_MAP


@pytest.mark.parametrize("compressed", [True, False])
@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32])
def test_mha_roundtrip(tmp_path, rng, compressed, dtype):
    arr = (rng.randn(13, 17, 19) * 100).astype(dtype)
    spacing = (0.7, 0.7, 2.0)
    origin = (-100.0, -120.0, 50.0)
    direction = tuple(np.eye(3).ravel())
    path = tmp_path / "x.mha"
    write_mha(path, arr, spacing, origin, direction, compressed=compressed)
    img = read_mha(path)
    np.testing.assert_array_equal(img.array, arr)
    np.testing.assert_allclose(img.spacing, spacing)
    np.testing.assert_allclose(img.origin, origin)
    np.testing.assert_allclose(img.direction, direction)


def _make_synthetic_ct(shape=(40, 50, 60), seed=0):
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.mgrid[:shape[0], :shape[1], :shape[2]]
    lobe = ((((zz - shape[0] / 2) / (shape[0] * 0.35)) ** 2
             + ((yy - shape[1] / 2) / (shape[1] * 0.3)) ** 2
             + ((xx - shape[2] / 2) / (shape[2] * 0.35)) ** 2) < 1)
    ct = np.full(shape, -700, np.int16)
    ct[lobe] = (-880 + 50 * rng.randn(lobe.sum())).astype(np.int16)
    return ct, lobe.astype(np.uint8)


def test_inference_dataset(tmp_path):
    scan_dir = tmp_path / "ct"
    lobe_dir = tmp_path / "lobes"
    scan_dir.mkdir()
    lobe_dir.mkdir()
    ct, lobe = _make_synthetic_ct()
    write_mha(scan_dir / "case1.mha", ct, (0.7, 0.7, 2.0))
    write_mha(lobe_dir / "case1.mha", lobe, (0.7, 0.7, 2.0))
    ds = SubtypingInference(str(scan_dir), str(lobe_dir))
    assert len(ds) == 1
    item = ds[0]
    assert item["uid"] == "case1"
    assert item["image"].dtype == np.int16
    crop = item["crop_slice"]
    assert (crop[:, 1] > crop[:, 0]).all()
    # cropped shape matches the crop slices
    want_shape = tuple(int(b - a) for a, b in crop)
    assert item["image"].shape == want_shape
    # outside dilated lung was pushed to -2048 somewhere in the crop border
    assert item["image"].min() == -2048
    # ess mask within lung and below -910
    assert item["ess_mask"].sum() > 0
    assert (item["image"][item["ess_mask"]] < -910).all()
    assert ds.scan_meta_cache["case1"]["spacing"] == (2.0, 0.7, 0.7)


def test_inference_dataset_reference_semantics(tmp_path):
    """The crop-local dilation/mask-out must reproduce the
    reference order exactly: dilate FULL volume ×2, mask −2048, crop
    (reference dataset.py:68-71) — including a lung touching the volume
    edge (crop == whole volume, exercising the codec's read-only view)."""
    from bodyct_dram_emph_subtype.ops.morphology import (
        binary_dilate_np, find_crops_np)
    scan_dir = tmp_path / "ct"
    lobe_dir = tmp_path / "lobes"
    scan_dir.mkdir()
    lobe_dir.mkdir()
    rng = np.random.RandomState(3)
    ct = rng.randint(-1100, -600, (20, 22, 24)).astype(np.int16)
    lobe = np.zeros_like(ct, np.uint8)
    lobe[0:20, 1:21, 0:24] = rng.rand(20, 20, 24) > 0.5  # edge-touching
    write_mha(scan_dir / "edge.mha", ct, (0.7, 0.7, 0.7))
    write_mha(lobe_dir / "edge.mha", lobe, (0.7, 0.7, 0.7))
    item = SubtypingInference(str(scan_dir), str(lobe_dir))[0]
    lung = lobe > 0
    masked = ct.copy()
    masked[~binary_dilate_np(lung, 2)] = -2048
    sl = find_crops_np(lung, (0.7, 0.7, 0.7), 5)
    np.testing.assert_array_equal(item["image"], masked[sl])
    np.testing.assert_array_equal(item["original_image"], ct[sl])
    np.testing.assert_array_equal(item["lung_mask"], lung[sl])
    np.testing.assert_array_equal(
        item["ess_mask"], (masked[sl] < -910) & lung[sl])
    # lean mode (the deployment device pipeline): same image, no extras
    lean = SubtypingInference(str(scan_dir), str(lobe_dir),
                              keep_original=False, compute_ess=False)[0]
    np.testing.assert_array_equal(lean["image"], item["image"])
    assert "original_image" not in lean and "ess_mask" not in lean


def test_inference_dataset_float_scan_ess_threshold(tmp_path):
    """The −910 HU ess threshold must apply to the NATIVE-dtype voxels
    (reference compares before any cast): a float scan voxel at −910.4
    is ess; int16 truncation to −910 would wrongly exclude it."""
    scan_dir = tmp_path / "ct"
    lobe_dir = tmp_path / "lobes"
    scan_dir.mkdir()
    lobe_dir.mkdir()
    ct = np.full((8, 8, 8), -700.0, np.float32)
    lobe = np.zeros((8, 8, 8), np.uint8)
    lobe[2:6, 2:6, 2:6] = 1
    ct[3, 3, 3] = -910.4          # ess only if compared pre-cast
    ct[4, 4, 4] = -909.6          # never ess
    write_mha(scan_dir / "f.mha", ct, (1.0, 1.0, 1.0))
    write_mha(lobe_dir / "f.mha", lobe, (1.0, 1.0, 1.0))
    item = SubtypingInference(str(scan_dir), str(lobe_dir))[0]
    crop = item["crop_slice"]
    ess = item["ess_mask"]
    p = tuple(3 - int(a) for a, _ in crop)
    q = tuple(4 - int(a) for a, _ in crop)
    assert bool(ess[p]) and not bool(ess[q])


def test_find_crops_np_matches_nonzero_reference():
    import math
    from bodyct_dram_emph_subtype.ops.morphology import find_crops_np
    rng = np.random.RandomState(7)
    for _ in range(10):
        shape = tuple(rng.randint(5, 30, 3))
        mask = rng.rand(*shape) > 0.97
        mask[tuple(d // 2 for d in shape)] = True
        spacing = rng.uniform(0.4, 2.5, 3)
        border = int(rng.choice([0, 5]))
        nz = np.nonzero(mask)
        want = []
        for ax in range(3):
            s, e = int(nz[ax].min()), int(nz[ax].max()) + 1
            if border > 0:
                p = int(math.ceil(border / spacing[ax]))
                s, e = max(0, s - p), min(shape[ax], e + p)
            want.append(slice(s, e))
        assert find_crops_np(mask, spacing, border) == tuple(want)
    with pytest.raises(ValueError):
        find_crops_np(np.zeros((4, 4, 4), bool), (1.0, 1.0, 1.0), 0)


def make_training_archive(tmp_path, n=24, shape=(16, 20, 24), seed=0):
    rng = np.random.RandomState(seed)
    rows = ["SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
            "CT_Visual_Emph_Paraseptal_P1"]
    uids = []
    for i in range(n):
        uid = f"series{i:03d}"
        uids.append(uid)
        cle = i % 6
        pse = i % 3
        rows.append(f"{uid},{cle},{pse}")
        img = (rng.randn(*shape) * 150 - 850).astype(np.int16)
        lung = (rng.rand(*shape) > 0.4)
        np.savez(tmp_path / f"{uid}.npz", image=img, lung_mask=lung,
                 cls_label=cle, pse_label=pse)
    (tmp_path / "merged.csv").write_text("\n".join(rows) + "\n")
    return uids


def test_training_dataset_and_sampler(tmp_path):
    make_training_archive(tmp_path)
    csv = str(tmp_path / "merged.csv")
    uids = COPDGeneSubtyping.get_series_uids(csv)
    assert len(uids) == 24
    ds = COPDGeneSubtyping(str(tmp_path), uids)
    item = ds[3]
    assert item["em_mask"].shape == item["image"].shape
    assert (item["em_mask"] == ((item["image"] < -950)
                                & (item["lung_mask"] > 0))).all()
    assert item["index"][0] == 3

    sampler = SubtypingStratifiedSampler(ds, balance_label_count=8, seed=1)
    assert sampler.num_samples == 6 * 8
    assert len(sampler.cle_class_weights) == 6
    assert len(sampler.pse_class_weights) == 3
    np.testing.assert_allclose(sum(sampler.cle_statistics.values()), 1.0,
                               atol=1e-6)
    indices = list(iter(sampler))
    assert len(indices) == 48
    # stratification: all 6 classes appear
    labels = [ds.subtyping_labels[ds.series_uids[i]]["cle"] for i in indices]
    assert set(labels) == set(range(6))


def test_sampler_missing_class_gets_max_weight(tmp_path):
    sub = tmp_path / "sub"
    sub.mkdir()
    rows = ["SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
            "CT_Visual_Emph_Paraseptal_P1"]
    for i in range(10):
        rows.append(f"s{i},{i % 3},{i % 2}")  # only CLE classes 0-2 present
        np.savez(sub / f"s{i}.npz", image=np.zeros((4, 4, 4), np.int16),
                 lung_mask=np.ones((4, 4, 4), bool), cls_label=i % 3,
                 pse_label=i % 2)
    (sub / "merged.csv").write_text("\n".join(rows) + "\n")
    ds = COPDGeneSubtyping(str(sub), COPDGeneSubtyping.get_series_uids(
        str(sub / "merged.csv")))
    sampler = SubtypingStratifiedSampler(ds, 4, seed=0)
    assert len(sampler.cle_class_weights) == 6
    assert sampler.num_samples == 3 * 4  # only present classes counted
    assert sampler.cle_statistics[5] == 1e-5


def test_balanced_class_weights_matches_sklearn():
    from sklearn.utils.class_weight import compute_class_weight
    y = np.asarray([0, 0, 0, 1, 1, 2])
    want = compute_class_weight(class_weight="balanced",
                                classes=np.unique(y), y=y)
    np.testing.assert_allclose(balanced_class_weights(y), want)


def test_shard_indices_partitions_everything():
    idx = list(range(10))
    shards = [shard_indices(idx, 4, r, shuffle=True, epoch=3)
              for r in range(4)]
    assert all(len(s) == 3 for s in shards)  # padded to 12
    seen = np.concatenate(shards)
    assert set(seen) == set(idx)
    # same epoch → same permutation on every "process"
    again = shard_indices(idx, 4, 2, shuffle=True, epoch=3)
    np.testing.assert_array_equal(shards[2], again)
    # different epoch → different permutation
    other = shard_indices(idx, 4, 2, shuffle=True, epoch=4)
    assert not np.array_equal(shards[2], other)


def test_dataloader_batches_and_order(tmp_path):
    make_training_archive(tmp_path)
    ds = COPDGeneSubtyping(str(tmp_path),
                           COPDGeneSubtyping.get_series_uids(
                               str(tmp_path / "merged.csv")))
    loader = DataLoader(ds, indices=list(range(10)), batch_size=4,
                        drop_last=True, num_workers=2)
    batches = list(loader)
    assert len(batches) == 2
    assert batches[0]["image"].shape == (4, 16, 20, 24)
    np.testing.assert_array_equal(batches[0]["index"].ravel(), [0, 1, 2, 3])
    np.testing.assert_array_equal(batches[1]["index"].ravel(), [4, 5, 6, 7])


def test_ratio_to_label_host():
    assert ratio_to_label(0.0, CLE_RATIO_MAP) == 0
    assert ratio_to_label(0.15, CLE_RATIO_MAP) == 3
    assert ratio_to_label(0.9, CLE_RATIO_MAP) == 5


def test_training_dataset_reads_torch_pth_cache(tmp_path, rng):
    """Reference-format .pth caches load without torch at runtime."""
    import torch

    rows = ["SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
            "CT_Visual_Emph_Paraseptal_P1", "u1,4,2"]
    (tmp_path / "merged.csv").write_text("\n".join(rows) + "\n")
    img = rng.randint(-1200, 0, (10, 12, 14)).astype(np.int16)
    lung = rng.rand(10, 12, 14) > 0.4
    torch.save({"image": torch.from_numpy(img),
                "lung_mask": torch.from_numpy(lung),
                "cls_label": 4, "pse_label": 2}, tmp_path / "u1.pth")
    ds = COPDGeneSubtyping(str(tmp_path), ["u1"])
    item = ds[0]
    np.testing.assert_array_equal(item["image"], img)
    assert (item["em_mask"] == ((img < -950) & lung)).all()

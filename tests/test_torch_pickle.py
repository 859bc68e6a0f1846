"""Torch-free .pth reader vs torch.save as oracle."""
import numpy as np
import pytest
import torch

from bodyct_dram_emph_subtype.data.torch_pickle import (
    load_state_dict,
    load_torch_file,
)


def test_reads_plain_dict_of_tensors(tmp_path, rng):
    data = {
        "f32": torch.from_numpy(rng.randn(3, 4, 5).astype(np.float32)),
        "f64": torch.from_numpy(rng.randn(2, 3).astype(np.float64)),
        "i64": torch.from_numpy(rng.randint(-5, 5, (7,))),
        "i16": torch.from_numpy(rng.randint(-1000, 1000, (4, 4)).astype(np.int16)),
        "u8": torch.from_numpy(rng.randint(0, 255, (2, 2)).astype(np.uint8)),
        "bool": torch.from_numpy(rng.rand(3, 3) > 0.5),
        "scalar": torch.tensor(3.5),
        "label": 4,
        "name": "series-1",
    }
    path = tmp_path / "blob.pth"
    torch.save(data, path)
    out = load_torch_file(path)
    for key in ("f32", "f64", "i64", "i16", "u8", "bool"):
        np.testing.assert_array_equal(out[key], data[key].numpy())
    assert float(out["scalar"]) == 3.5
    assert out["label"] == 4 and out["name"] == "series-1"


def test_reads_noncontiguous_tensor(tmp_path, rng):
    t = torch.from_numpy(rng.randn(6, 8).astype(np.float32)).t()  # strided
    path = tmp_path / "strided.pth"
    torch.save({"t": t}, path)
    out = load_torch_file(path)
    np.testing.assert_array_equal(out["t"], t.numpy())


def test_reads_module_state_dict_with_lightning_envelope(tmp_path):
    lin = torch.nn.Sequential(torch.nn.Conv3d(1, 4, 3),
                              torch.nn.BatchNorm3d(4))
    ckpt = {"state_dict": {f"model.{k}": v
                           for k, v in lin.state_dict().items()},
            "epoch": 12, "pytorch-lightning_version": "1.9.1"}
    path = tmp_path / "ckpt.ckpt"
    torch.save(ckpt, path)
    sd = load_state_dict(path)
    assert "model.0.weight" in sd
    np.testing.assert_array_equal(sd["model.0.weight"],
                                  lin.state_dict()["0.weight"].numpy())
    # running stats + num_batches_tracked scalars come through
    assert "model.1.running_mean" in sd


def test_bfloat16_roundtrip(tmp_path):
    t = torch.arange(8, dtype=torch.bfloat16) / 3
    path = tmp_path / "bf16.pth"
    torch.save({"t": t}, path)
    out = load_torch_file(path)
    np.testing.assert_array_equal(out["t"].astype(np.float32),
                                  t.float().numpy())


def test_training_cache_shape(tmp_path, rng):
    """The exact cache schema the reference training reads
    (dataset.py:148)."""
    img = rng.randint(-1200, 400, (20, 30, 40)).astype(np.int16)
    lung = rng.rand(20, 30, 40) > 0.5
    torch.save({"image": torch.from_numpy(img),
                "lung_mask": torch.from_numpy(lung),
                "cls_label": 3, "pse_label": 1}, tmp_path / "uid.pth")
    out = load_torch_file(tmp_path / "uid.pth")
    np.testing.assert_array_equal(out["image"], img)
    np.testing.assert_array_equal(out["lung_mask"], lung)
    assert out["cls_label"] == 3

#!/usr/bin/env python
"""Build the training cache: paired scan/lobe MHA directories → per-series
``.npz`` archives + ``merged.csv``.

The reference trains from pre-cached ``{uid}.pth`` dicts (``dataset.py:148``)
built by an out-of-repo pipeline; this tool is the in-repo, torch-free
equivalent for the framework's ``.npz`` cache format.  It applies the
same per-scan preparation as the inference dataset: lung = lobe>0, dilate
x2, outside→−2048, crop to lung bbox + border.

Usage:
  python tools/build_cache.py --scan_path ct/ --lobe_path lobes/ \
      --labels_csv labels.csv --output_path cache/
It can also convert an existing torch cache:
  python tools/build_cache.py --torch_cache old_cache/ --output_path cache/
"""
import argparse
import shutil
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bodyct_dram_emph_subtype.data import (  # noqa: E402
    SubtypingInference,
    read_csv_in_dict,
)


def convert_torch_cache(torch_cache: Path, output: Path):
    import torch
    output.mkdir(parents=True, exist_ok=True)
    for pth in sorted(torch_cache.glob("*.pth")):
        data = torch.load(pth, map_location="cpu", weights_only=False)
        np.savez_compressed(
            output / f"{pth.stem}.npz",
            **{k: (v.numpy() if hasattr(v, "numpy") else np.asarray(v))
               for k, v in data.items()})
        print(f"converted {pth.stem}")
    csv = torch_cache / "merged.csv"
    if csv.exists():
        shutil.copy(csv, output / "merged.csv")


def build_from_mha(scan_path: str, lobe_path: str, labels_csv: str,
                   output: Path):
    output.mkdir(parents=True, exist_ok=True)
    labels, _ = read_csv_in_dict(labels_csv, "SeriesInstanceUID")
    ds = SubtypingInference(scan_path, lobe_path)
    rows = ["SeriesInstanceUID,CT_Visual_Emph_Severity_P1,"
            "CT_Visual_Emph_Paraseptal_P1"]
    for i in range(len(ds)):
        item = ds[i]
        uid = item["uid"]
        if uid not in labels:
            print(f"skip {uid}: no labels")
            continue
        cle = int(float(labels[uid]["CT_Visual_Emph_Severity_P1"]))
        pse = int(float(labels[uid]["CT_Visual_Emph_Paraseptal_P1"]))
        np.savez_compressed(output / f"{uid}.npz",
                            image=item["image"].astype(np.int16),
                            lung_mask=item["lung_mask"].astype(bool),
                            cls_label=cle, pse_label=pse)
        rows.append(f"{uid},{cle},{pse}")
        print(f"cached {uid} {item['image'].shape}")
    (output / "merged.csv").write_text("\n".join(rows) + "\n")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--scan_path", type=str)
    parser.add_argument("--lobe_path", type=str)
    parser.add_argument("--labels_csv", type=str)
    parser.add_argument("--torch_cache", type=str)
    parser.add_argument("--output_path", required=True, type=str)
    args = parser.parse_args()
    output = Path(args.output_path)
    if args.torch_cache:
        convert_torch_cache(Path(args.torch_cache), output)
    else:
        if not (args.scan_path and args.lobe_path and args.labels_csv):
            parser.error("need --scan_path --lobe_path --labels_csv "
                         "(or --torch_cache)")
        build_from_mha(args.scan_path, args.lobe_path, args.labels_csv,
                       output)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Label distribution by split (parity with the reference
``compute_label_statistics.py`` probe): counts + frequencies of the CLE and
PSE scores for each CSV.

Usage:
  python tools/compute_label_statistics.py --csvs tr.csv,val.csv,te.csv
"""
import argparse
import json
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from bodyct_dram_emph_subtype.data import read_csv_in_dict  # noqa: E402


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--csvs", required=True,
                        help="comma-separated CSV paths")
    args = parser.parse_args()
    for csv_path in args.csvs.split(","):
        rows, _ = read_csv_in_dict(csv_path, "SeriesInstanceUID")
        cle = Counter(int(float(r["CT_Visual_Emph_Severity_P1"]))
                      for r in rows.values())
        pse = Counter(int(float(r["CT_Visual_Emph_Paraseptal_P1"]))
                      for r in rows.values())
        n = max(len(rows), 1)
        print(json.dumps({
            "csv": csv_path, "n": len(rows),
            "cle_counts": {k: cle.get(k, 0) for k in range(6)},
            "cle_freq": {k: round(cle.get(k, 0) / n, 4) for k in range(6)},
            "pse_counts": {k: pse.get(k, 0) for k in range(3)},
            "pse_freq": {k: round(pse.get(k, 0) / n, 4) for k in range(3)},
        }))


if __name__ == "__main__":
    main()

#!/usr/bin/env bash
# Save the container image for upload (parity with reference export.sh)
set -euo pipefail
./build.sh
docker save dram_emph_subtype | gzip -c > dram_emph_subtype.tar.gz

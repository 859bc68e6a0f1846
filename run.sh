#!/usr/bin/env bash
# Run the processor on mounted /input -> /output (parity with reference run.sh)
set -euo pipefail
./build.sh
docker run --rm --privileged \
    -v "$1":/input/ \
    -v "$2":/output/ \
    dram_emph_subtype

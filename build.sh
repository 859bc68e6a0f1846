#!/usr/bin/env bash
# Build the algorithm container (parity with reference build.sh)
set -euo pipefail
SCRIPTPATH="$( cd "$(dirname "$0")" ; pwd -P )"
docker build -t dram_emph_subtype "$SCRIPTPATH"

#!/bin/sh
# Build the host runtime (host_runtime.cpp) ahead of its first use, by
# the one build path the package uses at run time: csrc.build_host()
# (g++ -O3 -shared -fPIC -std=c++17 -pthread into csrc/build/).
set -e
cd "$(dirname "$0")/../.."
python3 -c 'from apex_tpu_torch import csrc; print("built", csrc.build_host())'

#!/bin/sh
# Static-analysis gate, pre-commit / CI shape:
#
#     brpc_tpu_torch/tools/check/run_all.sh            # whole suite
#     brpc_tpu_torch/tools/check/run_all.sh --fail-fast
#
# Exit 0 = clean tree, 1 = findings, 2 = suite error — plain
# `python -m brpc_tpu_torch.tools.check` semantics, from any cwd.
set -eu
cd "$(dirname "$0")/../../.."
exec "${PYTHON:-python3}" -m brpc_tpu_torch.tools.check "$@"

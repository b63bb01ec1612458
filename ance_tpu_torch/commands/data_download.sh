#!/bin/bash
# Public dataset downloads (MS MARCO + DPR resources): the same files for
# both packages, so this runs the JAX package's script by path
# (commands/data_download.sh at the repository root).
#   bash ance_tpu_torch/commands/data_download.sh [DIR]
set -euo pipefail
exec bash "$(dirname "$0")/../../commands/data_download.sh" "$@"

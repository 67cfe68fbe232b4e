#!/usr/bin/env bash
# Multi-process evaluation of the PyTorch port: one process a card under
# torchrun, over every visible card unless NPROC says otherwise (each rank
# scores its shard and the totals are summed; with --shard-windows each
# frame's slide windows are spread over the ranks instead).
#   tools/dist_test.sh CONFIG CHECKPOINT [extra args of tools/test.py...]
set -euo pipefail
CONFIG=$1; CKPT=$2; shift 2 || true
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
if [ -z "${NPROC:-}" ]; then
    NPROC=$(python3 -c 'import torch; print(max(torch.cuda.device_count(), 1))')
fi
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
TORCHRUN=$(command -v torchrun || echo "python3 -m torch.distributed.run")
exec $TORCHRUN --standalone --nproc_per_node="$NPROC" \
    -m denseclip_vit_multimodal_tpu_torch.tools.test "$CONFIG" "$CKPT" "$@"

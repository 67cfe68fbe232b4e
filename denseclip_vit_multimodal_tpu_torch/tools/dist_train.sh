#!/usr/bin/env bash
# Data-parallel training of the PyTorch port: one process a card under
# torchrun, over every visible card unless NPROC says otherwise
# (tools/train.py joins the group torchrun describes; the batch size in the
# config is the global batch).
#   tools/dist_train.sh CONFIG [extra args of tools/train.py...]
#   NPROC=2 tools/dist_train.sh CONFIG --device cpu   (Gloo ranks on the CPU)
set -euo pipefail
CONFIG=$1; shift || true
ROOT="$(cd "$(dirname "$0")/../.." && pwd)"
if [ -z "${NPROC:-}" ]; then
    NPROC=$(python3 -c 'import torch; print(max(torch.cuda.device_count(), 1))')
fi
export PYTHONPATH="$ROOT${PYTHONPATH:+:$PYTHONPATH}"
TORCHRUN=$(command -v torchrun || echo "python3 -m torch.distributed.run")
exec $TORCHRUN --standalone --nproc_per_node="$NPROC" \
    -m denseclip_vit_multimodal_tpu_torch.tools.train "$CONFIG" "$@"

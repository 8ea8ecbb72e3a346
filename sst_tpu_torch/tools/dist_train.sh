#!/usr/bin/env bash
# The port's train CLI with one process per card (counterpart of the JAX
# package's tools/dist_train.sh, after the reference's torch launcher):
# torchrun starts GPUS processes on this node, each joining the process
# group from the RANK / WORLD_SIZE / LOCAL_RANK it sets, and the CLI checks
# that the group holds NNODES * GPUS ranks (--expect-devices).
#
#   sst_tpu_torch/tools/dist_train.sh CONFIG GPUS [train CLI arguments]
#
# One node with no MASTER_PORT given: torchrun --standalone, whose
# rendezvous takes a free local port, so two runs on one host never meet.
# Several nodes: run it once per node with the same NNODES, MASTER_ADDR
# and MASTER_PORT and each node's NODE_RANK:
#   NNODES=2 NODE_RANK=$i MASTER_ADDR=host0 MASTER_PORT=29500 \
#     sst_tpu_torch/tools/dist_train.sh cfg.py 8
CONFIG=$1
GPUS=$2
shift 2

NNODES=${NNODES:-1}
NODE_RANK=${NODE_RANK:-0}

if [ "$NNODES" = 1 ] && [ -z "$MASTER_PORT" ]; then
  RDZV=(--standalone)
else
  RDZV=(--nnodes "$NNODES" --node-rank "$NODE_RANK"
        --master-addr "${MASTER_ADDR:-127.0.0.1}"
        --master-port "${MASTER_PORT:-29500}")
fi

PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH \
python3 -m torch.distributed.run "${RDZV[@]}" \
  --nproc-per-node "$GPUS" -m sst_tpu_torch.tools.train "$CONFIG" \
  --expect-devices $((NNODES * GPUS)) "$@"

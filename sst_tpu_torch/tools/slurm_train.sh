#!/usr/bin/env bash
# The port's train CLI under slurm (counterpart of the JAX package's
# tools/slurm_train.sh, after the reference's): one task per card, as the
# port runs one process per card (JAX runs one per host). Each task joins
# the process group as rank SLURM_PROCID of SLURM_NTASKS, on card
# SLURM_LOCALID, with the job's first node as the rendezvous; the CLI checks
# the group's size (--expect-devices).
#
# Usage: GPUS_PER_NODE=8 NODES=2 sst_tpu_torch/tools/slurm_train.sh \
#          <partition> <job> <config> <workdir> [train CLI arguments]
set -x

PARTITION=$1
JOB_NAME=$2
CONFIG=$3
WORK_DIR=$4
NODES=${NODES:-1}
GPUS_PER_NODE=${GPUS_PER_NODE:-8}
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
MASTER_PORT=${MASTER_PORT:-29500}
SRUN_ARGS=${SRUN_ARGS:-""}
PY_ARGS=${@:5}

PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH \
srun -p ${PARTITION} \
    --job-name=${JOB_NAME} \
    --nodes=${NODES} \
    --gres=gpu:${GPUS_PER_NODE} \
    --ntasks=$((NODES * GPUS_PER_NODE)) \
    --ntasks-per-node=${GPUS_PER_NODE} \
    --cpus-per-task=${CPUS_PER_TASK} \
    --kill-on-bad-exit=1 \
    ${SRUN_ARGS} \
    bash -c 'MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1) \
      RANK=$SLURM_PROCID WORLD_SIZE=$SLURM_NTASKS LOCAL_RANK=$SLURM_LOCALID \
      MASTER_PORT='"${MASTER_PORT}"' \
      exec python3 -u -m sst_tpu_torch.tools.train "$@"' _ \
    ${CONFIG} --work-dir=${WORK_DIR} \
    --expect-devices $((NODES * GPUS_PER_NODE)) ${PY_ARGS}

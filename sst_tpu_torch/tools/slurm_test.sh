#!/usr/bin/env bash
# The port's test CLI under slurm (counterpart of the JAX package's
# tools/slurm_test.sh): one task on one card, as the test CLI predicts the
# whole set in one process.
#
# Usage: sst_tpu_torch/tools/slurm_test.sh <partition> <job> <config> \
#          <checkpoint> [test CLI arguments]
set -x

PARTITION=$1
JOB_NAME=$2
CONFIG=$3
CHECKPOINT=$4
CPUS_PER_TASK=${CPUS_PER_TASK:-5}
SRUN_ARGS=${SRUN_ARGS:-""}
PY_ARGS=${@:5}

PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH \
srun -p ${PARTITION} \
    --job-name=${JOB_NAME} \
    --nodes=1 \
    --gres=gpu:1 \
    --ntasks=1 \
    --cpus-per-task=${CPUS_PER_TASK} \
    --kill-on-bad-exit=1 \
    ${SRUN_ARGS} \
    python3 -u -m sst_tpu_torch.tools.test ${CONFIG} ${CHECKPOINT} ${PY_ARGS}

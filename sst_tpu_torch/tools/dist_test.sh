#!/usr/bin/env bash
# The port's test CLI (counterpart of the JAX package's tools/dist_test.sh).
# The test CLI predicts the whole set in one process on one card, as JAX's
# does on one host, so GPUS is taken for the reference's interface and the
# run is a single process.
#
#   sst_tpu_torch/tools/dist_test.sh CONFIG CHECKPOINT GPUS [test CLI arguments]
CONFIG=$1
CKPT=$2
GPUS=$3
shift 3
PYTHONPATH="$(dirname "$0")/../..":$PYTHONPATH \
python3 -m sst_tpu_torch.tools.test "$CONFIG" "$CKPT" "$@"

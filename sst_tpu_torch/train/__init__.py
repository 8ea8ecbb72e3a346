"""Training: the optimizer and its schedule, the train step and the
step-dependent training schedules (counterpart of ``sst_tpu/train``)."""

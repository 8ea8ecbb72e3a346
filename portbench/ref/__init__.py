"""The plain reference of the benchmark's checks: a frozen copy of the
port's model, loss, train-step and optimizer code (``sst_tpu_torch`` as of
the benchmark's first version; the dense FSDv2 single stage and SST with
the anchor head), with every hand-written kernel replaced by plain PyTorch
(the sorted reduce by its scatter twin, the window attention by float32
einsums under autograd) and every product and map in float32 unless
``precision.lower_precision`` asks for the control's 8 bits. It imports
nothing of ``sst_tpu_torch``, ``sst_tpu`` or JAX, so a later change to the
port does not move it."""

"""Misc tools of the port (counterparts of the JAX package's
``tools/misc``), each run as ``python -m sst_tpu_torch.tools.misc.<name>``:
``print_config`` (a config with its bases and overrides resolved),
``browse_dataset`` (BEV PNGs and OBJ dumps of a dataset's samples),
``visualize_results`` (the same over a ``tools.test --out`` pickle) and
``fuse_conv_bn`` (batch norms folded into the convs of a checkpoint)."""

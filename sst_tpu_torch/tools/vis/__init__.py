"""``show_bin`` (counterpart of the JAX package's ``tools/vis``): a Waymo
Objects bin rendered as BEV PNGs, run as
``python -m sst_tpu_torch.tools.vis.show_bin``."""

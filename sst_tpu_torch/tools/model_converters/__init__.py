"""``fsd_pretrain_converter`` (counterpart of the JAX package's
``tools/model_converters``): a segmentation pretrain grafted into a
detector's checkpoint, run as
``python -m sst_tpu_torch.tools.model_converters.fsd_pretrain_converter``."""

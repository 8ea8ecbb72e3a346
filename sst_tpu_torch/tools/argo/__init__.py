"""Argoverse 2 tools of the port (counterparts of the JAX package's
``tools/argo``), each run as ``python -m sst_tpu_torch.tools.argo.<name>``:
``argo2_converter`` (sensor-dataset feathers → infos and point bins),
``gather_argo2_anno_feather`` (one gt feather of a split),
``eval_feather`` (CDS of a prediction feather) and ``create_roi_mask``
(per-point ROI, ground and drivable masks). They read and write feathers
through pandas and pyarrow, imported inside the functions that need them."""

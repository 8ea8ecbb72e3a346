"""Analysis tools of the port (counterparts of the JAX package's
``tools/analysis_tools``), each run as
``python -m sst_tpu_torch.tools.analysis_tools.<name>``: ``benchmark``
(predict latency and frames per second of a config)."""

"""Analysis tools of the port (counterparts of the JAX package's
``tools/analysis_tools``), each run as
``python -m sst_tpu_torch.tools.analysis_tools.<name>``: ``benchmark``
(predict latency and frames per second of a config), ``analyze_logs``
(step times and loss curves of a ``train_log.jsonl``; the curves as a PNG
where matplotlib imports), ``eval_nus_json`` (NDS of a nuScenes
submission json against an info pkl) and ``calibrate_synthetic`` (the
synthetic protocol's sensitivity per class)."""

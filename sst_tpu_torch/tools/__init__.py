"""Command-line tools of the port: the train and test CLIs, the profilers,
``analysis_tools/benchmark.py`` and ``soak.py`` (which run models, on the
card unless told ``--device cpu``); the offline scripts of ``ctrl/``,
``fsdpp/`` and ``create_submission.py`` (host code on Waymo bins,
tfrecords and pickles); the data preparation of ``create_data.py``,
``data_converter/`` and ``argo/``; ``analysis_tools/`` (logs, nuScenes
json, the synthetic protocol's calibration), ``misc/`` (configs, dataset
and result browsing, conv + batch-norm fusion), ``vis/`` and
``model_converters/`` (the FSD pretrain graft); and the launch wrappers
``dist_{train,test}.sh`` (torchrun) and ``slurm_{train,test}.sh``."""

"""Command-line tools of the port: the train and test CLIs, the profilers,
``analysis_tools/benchmark.py`` and ``soak.py`` (which run models, on the
card unless told ``--device cpu``), and the offline scripts of ``ctrl/``,
``fsdpp/`` and ``create_submission.py`` (host code on Waymo bins,
tfrecords and pickles)."""

"""FSD-family models of the port: FSDv2 single stage (dense-BEV and
sparse builds), FSD single and two stage, and FSD++ (``fsdpp.py``, the
incremental multi-frame two stage)."""

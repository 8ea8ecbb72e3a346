"""FSD-family models of the port: FSDv2 single stage (dense-BEV and
sparse builds), and FSD single and two stage (inference)."""

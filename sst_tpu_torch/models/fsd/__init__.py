"""FSD-family models of the port (FSDv2 single stage, dense-BEV build)."""

"""Build helpers for the port's hand-written CUDA kernels."""

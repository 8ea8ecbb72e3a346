"""PyTorch + CUDA port of ``sst_tpu`` for NVIDIA Hopper GPUs.

The package mirrors ``sst_tpu``'s layout and module names. It imports
``torch`` only: importing it builds no kernel and touches no GPU. Kernels
written by hand for Hopper live under ``csrc/`` and are compiled with
``nvcc`` the first time a CUDA tensor reaches their wrapper.
"""

__version__ = "0.1.0"

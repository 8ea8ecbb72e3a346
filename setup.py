"""Install sst_tpu (pure python + a lazily-built C++ helper library).

The native pointprep library is compiled on first use (g++), so no build
step is needed here; jax/flax/optax/orbax come from the environment.

``sst_tpu_torch`` is the PyTorch + CUDA port. It needs torch (not listed
below: the build for the card comes from the environment); its CUDA kernels
(``sst_tpu_torch/csrc/*.cu``) are compiled with nvcc on first use.
"""

from setuptools import find_packages, setup

setup(
    name="sst_tpu",
    version=open("sst_tpu/version.py").read().split('"')[1],
    description=(
        "TPU-native fully-sparse LiDAR 3D detection (SST / FSD / FSDv2 / "
        "FSD++ / CTRL) on JAX/XLA/Pallas"
    ),
    packages=find_packages(include=["sst_tpu", "sst_tpu.*", "sst_tpu_torch",
                                    "sst_tpu_torch.*"]),
    package_data={"sst_tpu.data.native": ["*.cc"],
                  "sst_tpu_torch": ["csrc/*.cu"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax", "flax", "optax", "orbax-checkpoint"],
)

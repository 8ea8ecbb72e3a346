"""Build CUDA sources under ``sst_tpu_torch/csrc/`` into shared libraries
with a plain C interface and load them with ``ctypes``.

A library is compiled with ``nvcc`` for ``sm_90a`` the first time it is
asked for, into ``csrc/build/`` (listed in ``.gitignore``), under a name keyed
by a hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. :func:`load_kernel_libraries` starts one ``nvcc``
per source, all at once, and waits for all of them. A failed build raises
with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an existing build was reused
    compiler_log: str


_LOADED: dict[str, KernelLibrary] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: a CUDA kernel of sst_tpu_torch can "
                       "only be built on a machine with the CUDA toolkit")


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def load_kernel_libraries(names: Iterable[str]) -> dict[str, KernelLibrary]:
    """Build (if needed) and load ``csrc/<name>.cu`` for each name, with one
    ``nvcc`` per missing library, all running together; cached per process."""
    names = list(names)
    builds = {}
    for name in names:
        if name in _LOADED:
            continue
        src = CSRC / f"{name}.cu"
        so = _library_path(src)
        if so.exists():
            _LOADED[name] = KernelLibrary(ctypes.CDLL(str(so)), so, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        builds[name] = (proc, time.perf_counter(), src, so, tmp)
    failed = []
    for name, (proc, t0, src, so, tmp) in builds.items():
        log = proc.communicate()[0]
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {src.name} "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, so)
        _LOADED[name] = KernelLibrary(ctypes.CDLL(str(so)), so, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _LOADED[name] for name in names}


def load_kernel_library(name: str) -> KernelLibrary:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return load_kernel_libraries([name])[name]

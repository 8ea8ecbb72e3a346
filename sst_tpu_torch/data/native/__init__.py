"""The point-prep library: ``pointprep.cc`` compiled with ``g++`` at first
use and loaded with ``ctypes`` (counterpart of ``sst_tpu/data/native``,
its two entry points that the pipelines call).

The JAX package's pipelines take this route wherever its library builds,
and a numpy route elsewhere; the two routes give different samples
(``PadToCap`` draws a seed on the native route only). The port builds the
same source and chooses its route the same way, so it feeds the model the
points JAX does on every machine. :func:`available` says whether the build
succeeded. The library goes to ``sst_tpu_torch/csrc/build/`` under a name
keyed by the source, the flags and the compiler's view of the host CPU
(``-march=native``), so a build made on another machine is never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("pointprep.cc")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "csrc" / "build"
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
_lock = threading.Lock()
_lib = None
_failed = False


def _target_macros() -> bytes:
    """The macros g++ defines for ``-march=native`` on this host (its CPU
    features), or b"" where there is no g++."""
    try:
        return subprocess.run(["g++", "-march=native", "-dM", "-E", "-x", "c++",
                               os.devnull], check=True, capture_output=True,
                              timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return b""


def _build() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()
                            + _target_macros()).hexdigest()[:16]
    lib = _BUILD_DIR / f"libpointprep_{digest}.so"
    if lib.exists():
        return lib
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                   capture_output=True)
    os.replace(tmp, lib)  # atomic: another process may build the same name
    return lib


def load():
    """The ctypes library, or None where it cannot be built (no g++)."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError):
            _failed = True
            return None
        i64, u64, f32p = (ctypes.c_int64, ctypes.c_uint64,
                          ctypes.POINTER(ctypes.c_float))
        lib.pp_range_filter.restype = i64
        lib.pp_range_filter.argtypes = [f32p, i64, i64, f32p]
        lib.pp_shuffle_pad.restype = i64
        lib.pp_shuffle_pad.argtypes = [f32p, i64, i64, f32p, i64, u64]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def range_filter(pts: np.ndarray, pcr) -> np.ndarray:
    """The rows of ``pts`` [N, C] inside ``pcr``, in order. The filter
    compacts a float32 C-contiguous ``pts`` in place and returns a view of
    it, as JAX's does."""
    lib = load()
    pts = np.ascontiguousarray(pts, np.float32)
    if lib is None:
        m = ((pts[:, 0] >= pcr[0]) & (pts[:, 0] < pcr[3])
             & (pts[:, 1] >= pcr[1]) & (pts[:, 1] < pcr[4])
             & (pts[:, 2] >= pcr[2]) & (pts[:, 2] < pcr[5]))
        return pts[m]
    pcr = np.ascontiguousarray(pcr, np.float32)
    n = lib.pp_range_filter(_fp(pts), len(pts), pts.shape[1], _fp(pcr))
    return pts[:n]


def shuffle_pad(pts: np.ndarray, cap: int, seed: int):
    """(out [cap, C] float32, kept): a uniform subset of ``pts`` (all of
    them where they fit) in a random order, then zero rows."""
    lib = load()
    pts = np.ascontiguousarray(pts, np.float32)
    out = np.zeros((cap, pts.shape[1]), np.float32)
    if lib is None:
        rng = np.random.RandomState(seed & 0x7FFFFFFF)
        keep = min(len(pts), cap)
        out[:keep] = pts[rng.permutation(len(pts))[:keep]]
        return out, keep
    keep = lib.pp_shuffle_pad(_fp(pts), len(pts), pts.shape[1], _fp(out), cap,
                              seed)
    return out, int(keep)

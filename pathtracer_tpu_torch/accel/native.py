"""ctypes bridge to the repository's native binned-SAH BVH builder.

The reference's ``accel/native.py`` on the same source,
``native/bvh_builder.cpp``, with two differences. The library is compiled
here, with ``g++`` and the flags of ``native/Makefile``, into
``build/native/libbvh-<hash>.so`` at the repository root, keyed by a hash
of the source, the flags and the host CPU target that ``-march=native``
selects (like ``ops/_build.py``), so nothing is ever written into
``native/``. And there is no fallback: where the library cannot be built
or the build fails, the caller gets the error, not the numpy builder's
different tree.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from .build import FlatBVH

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "bvh_builder.cpp"
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's CXXFLAGS.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-Wall",
             "-std=c++17")

_LIB: ctypes.CDLL | None = None
# The build record of this process: seconds (0.0 when already built), path.
BUILD: dict = {}


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native BVH builder needs a C++ "
                           "compiler (set CXX or put g++ on PATH)")
    return cxx


def _target() -> bytes:
    """What -march=native expands to on this host, so that a library built
    for another CPU is never loaded."""
    proc = subprocess.run([_compiler(), "-march=native", "-Q",
                           "--help=target"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ cannot report its native target:\n"
                           f"{proc.stderr}")
    return proc.stdout.encode()


def load() -> ctypes.CDLL:
    """The compiled builder, built first if needed; raises on failure."""
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    digest.update(_target())
    out = BUILD_DIR / f"libbvh-{digest.hexdigest()[:16]}.so"
    seconds = 0.0
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp),
                               str(SOURCE)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE} (exit "
                               f"{proc.returncode}):\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.bvh_build.restype = ctypes.c_int
    lib.bvh_build.argtypes = [fp, ctypes.c_int, ctypes.c_int, fp, fp, ip, ip,
                              ip, ip]
    BUILD.update(seconds=seconds, path=str(out))
    _LIB = lib
    return lib


def build_bvh_native(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                     max_leaf: int = 4) -> FlatBVH:
    """Binned-SAH flat BVH (the contract of accel/build.py:build_bvh)."""
    v0 = np.asarray(v0, np.float32)
    p1 = v0 + np.asarray(e1, np.float32)
    p2 = v0 + np.asarray(e2, np.float32)
    T = len(v0)
    if T == 0:
        z3 = np.zeros((0, 3), np.float32)
        z1 = np.zeros((0,), np.int32)
        return FlatBVH(z3, z3, z1, z1, z1, z1)
    lib = load()
    tris = np.ascontiguousarray(np.concatenate([v0, p1, p2], axis=1),
                                np.float32)  # (T, 9)
    cap = 2 * T
    lo = np.empty((cap, 3), np.float32)
    hi = np.empty((cap, 3), np.float32)
    first = np.empty((cap,), np.int32)
    count = np.empty((cap,), np.int32)
    skip = np.empty((cap,), np.int32)
    order = np.empty((T,), np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    n_nodes = lib.bvh_build(
        tris.ctypes.data_as(fp), T, max_leaf, lo.ctypes.data_as(fp),
        hi.ctypes.data_as(fp), first.ctypes.data_as(ip),
        count.ctypes.data_as(ip), skip.ctypes.data_as(ip),
        order.ctypes.data_as(ip),
    )
    if n_nodes <= 0:
        raise RuntimeError(f"bvh_build failed: {n_nodes}")
    return FlatBVH(lo=lo[:n_nodes].copy(), hi=hi[:n_nodes].copy(),
                   first=first[:n_nodes].copy(),
                   count=count[:n_nodes].copy(),
                   skip=skip[:n_nodes].copy(), order=order)

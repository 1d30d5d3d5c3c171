"""Native host-side kernels (C++ via ctypes) with numpy fallback.

The compute path is JAX/XLA on the accelerator; this package covers the *host* side of
the runtime — fast post-processing of large stored chains (IACT, weighted
moments, resampling) — mirroring the reference's host C++ L1 utilities
(`/root/reference/src/R_iact.cpp`, `summary.cpp`, `stratified_sample.cpp`).

The shared library is compiled on first use (g++ -O3) and cached next to the
source; all entry points degrade gracefully to numpy if compilation fails.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastdiag.cpp")
_LIB = os.path.join(_HERE, "libfastdiag.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-o", _LIB,
             _SRC],
            check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            lib.bssm_iact.restype = ctypes.c_double
            lib.bssm_iact.argtypes = [
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                ctypes.c_int64]
            lib.bssm_iact_batch.restype = None
            lib.bssm_iact_batch.argtypes = [
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                ctypes.c_int64, ctypes.c_int64,
                np.ctypeslib.ndpointer(np.float64, flags="C")]
            lib.bssm_weighted_moments.restype = None
            lib.bssm_weighted_moments.argtypes = [
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                ctypes.c_int64, ctypes.c_int64,
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                np.ctypeslib.ndpointer(np.float64, flags="C")]
            lib.bssm_stratified_sample.restype = None
            lib.bssm_stratified_sample.argtypes = [
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.float64, flags="C"),
                ctypes.c_int64,
                np.ctypeslib.ndpointer(np.int64, flags="C")]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def iact_batch(xs: np.ndarray) -> np.ndarray:
    """Batched Sokal IACT over rows of xs (m, n); native or numpy."""
    xs = np.ascontiguousarray(np.atleast_2d(xs), dtype=np.float64)
    m, n = xs.shape
    lib = get_lib()
    if lib is not None:
        out = np.empty(m, dtype=np.float64)
        lib.bssm_iact_batch(xs, m, n, out)
        return out
    from ..diagnostics.summary import iact as _py_iact
    return np.array([_py_iact(row) for row in xs])


def weighted_moments(x: np.ndarray, w: np.ndarray):
    """Streaming weighted mean/var over axis 0 of x (s, d)."""
    x = np.ascontiguousarray(np.atleast_2d(x), dtype=np.float64)
    w = np.ascontiguousarray(w, dtype=np.float64)
    s, d = x.shape
    lib = get_lib()
    if lib is not None:
        mean = np.empty(d)
        var = np.empty(d)
        lib.bssm_weighted_moments(x, w, s, d, mean, var)
        return mean, var
    sw = w.sum()
    mean = (w[:, None] * x).sum(0) / sw
    var = (w[:, None] * (x - mean) ** 2).sum(0) / sw
    return mean, var


def stratified_sample(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    """Host-side stratified resampling (reference semantics)."""
    p = np.ascontiguousarray(p, dtype=np.float64)
    r = np.ascontiguousarray(r, dtype=np.float64)
    lib = get_lib()
    if lib is not None:
        out = np.empty(len(r), dtype=np.int64)
        lib.bssm_stratified_sample(p, len(p), r, len(r), out)
        return out
    cp = np.cumsum(p)
    cp[-1] = 1.0
    u = (np.arange(len(r)) + r) / len(r)
    return np.clip(np.searchsorted(cp, u, side="left"), 0, len(p) - 1)

"""ctypes loader for the C++ native kernels (native/optconpy_native.cpp).

`make -C native` runs on first use in each process; its rule rebuilds
the shared library only when optconpy_native.cpp is newer, so the
library always matches the committed source. Every entry point has a
numpy fallback (fem/taylor_hood.py), so the
framework works without a compiler — the native path is the production
host substrate (element assembly, convection evaluation, ELL packing),
mirroring the reference's DOLFIN/FFC C++ layer (SURVEY.md SS2 row 9).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "liboptconpy_native.so"
_lib = None
_tried = False


def load(rebuild: bool = False):
    """Return the loaded library, building it if needed; None if that
    fails (no compiler, etc.) — callers then use the numpy path."""
    global _lib, _tried
    if _lib is not None and not rebuild:
        return _lib
    if _tried and not rebuild:
        return _lib
    _tried = True
    try:
        subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)]
            + (["-B"] if rebuild else []),
            check=True,
            capture_output=True,
        )
        lib = ctypes.CDLL(str(_LIB_PATH))
    except (OSError, subprocess.SubprocessError):
        return None

    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.th_element_matrices.argtypes = [
        f64p, i32p, ctypes.c_int64, f64p, f64p, f64p, f64p,
    ]
    lib.th_convection_apply.argtypes = [
        f64p, i32p, i32p, ctypes.c_int64, ctypes.c_int64, f64p, f64p,
    ]
    lib.csr_to_ell.argtypes = [
        f64p, i32p, i64p, ctypes.c_int64, ctypes.c_int64, f64p, i32p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return load() is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def element_matrices(vertices: np.ndarray, triangles: np.ndarray):
    """Native Taylor-Hood element blocks; returns (m_loc, k_loc, j_loc,
    area) with shapes (nt,6,6), (nt,6,6), (nt,3,6,2), (nt,)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    v = np.ascontiguousarray(vertices, dtype=np.float64)
    t = np.ascontiguousarray(triangles, dtype=np.int32)
    nt = len(t)
    m_loc = np.empty((nt, 6, 6))
    k_loc = np.empty((nt, 6, 6))
    j_loc = np.empty((nt, 3, 6, 2))
    area = np.empty(nt)
    lib.th_element_matrices(
        _ptr(v, ctypes.c_double), _ptr(t, ctypes.c_int32),
        ctypes.c_int64(nt), _ptr(m_loc, ctypes.c_double),
        _ptr(k_loc, ctypes.c_double), _ptr(j_loc, ctypes.c_double),
        _ptr(area, ctypes.c_double),
    )
    return m_loc, k_loc, j_loc, area


def convection_apply(
    vertices: np.ndarray,
    triangles: np.ndarray,
    tri_dofs: np.ndarray,
    ns: int,
    v_full: np.ndarray,
) -> np.ndarray:
    """Native N(v)v on the full dof set (host; reference-architecture
    get_convvec hot path)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    vv = np.ascontiguousarray(vertices, dtype=np.float64)
    t = np.ascontiguousarray(triangles, dtype=np.int32)
    d = np.ascontiguousarray(tri_dofs, dtype=np.int32)
    x = np.ascontiguousarray(v_full, dtype=np.float64)
    y = np.zeros(2 * ns)
    lib.th_convection_apply(
        _ptr(vv, ctypes.c_double), _ptr(t, ctypes.c_int32),
        _ptr(d, ctypes.c_int32), ctypes.c_int64(len(t)),
        ctypes.c_int64(ns), _ptr(x, ctypes.c_double),
        _ptr(y, ctypes.c_double),
    )
    return y


def csr_to_ell_arrays(a, k: int):
    """Native CSR -> padded-ELL pack; returns (data (m,k), cols (m,k))."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    m = a.shape[0]
    data = np.zeros((m, k))
    cols = np.zeros((m, k), dtype=np.int32)
    csr_data = np.ascontiguousarray(a.data, dtype=np.float64)
    csr_idx = np.ascontiguousarray(a.indices, dtype=np.int32)
    csr_ptr = np.ascontiguousarray(a.indptr, dtype=np.int64)
    lib.csr_to_ell(
        _ptr(csr_data, ctypes.c_double), _ptr(csr_idx, ctypes.c_int32),
        _ptr(csr_ptr, ctypes.c_int64), ctypes.c_int64(m),
        ctypes.c_int64(k), _ptr(data, ctypes.c_double),
        _ptr(cols, ctypes.c_int32),
    )
    return data, cols

"""ctypes bindings for the native mesh runtime ``native/meshops.cpp``: marching
tetrahedra and QEM decimation (the port's own copy of the JAX package's
numpy-only wrapper).  The library ``native/libmeshops.so`` is built with
``native/build.sh`` when missing; buffers are plain numpy arrays.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

_NATIVE = Path(__file__).resolve().parents[2] / "native"
_LIB = None

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        so = _NATIVE / "libmeshops.so"
        if not so.exists():
            subprocess.check_call(["sh", str(_NATIVE / "build.sh")])
        lib = ctypes.CDLL(str(so))
        lib.marching_tets.restype = ctypes.c_int
        lib.marching_tets.argtypes = [
            _FP, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            _FP, _FP, ctypes.POINTER(_FP), _I64P, ctypes.POINTER(_IP), _I64P,
        ]
        lib.decimate_qem.restype = ctypes.c_int
        lib.decimate_qem.argtypes = [
            _FP, ctypes.c_int64, _IP, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(_FP), _I64P, ctypes.POINTER(_IP), _I64P,
        ]
        lib.mesh_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _collect(lib, pv, nv, pt, nt) -> Tuple[np.ndarray, np.ndarray]:
    n_v, n_t = nv.value, nt.value
    verts = np.ctypeslib.as_array(pv, shape=(max(n_v, 1), 3))[:n_v].copy()
    tris = np.ctypeslib.as_array(pt, shape=(max(n_t, 1), 3))[:n_t].copy()
    lib.mesh_free(ctypes.cast(pv, ctypes.c_void_p))
    lib.mesh_free(ctypes.cast(pt, ctypes.c_void_p))
    return verts.astype(np.float32), tris.astype(np.int32)


def marching_tets(grid: np.ndarray, iso: float, origin=(0.0, 0.0, 0.0),
                  spacing=(1.0, 1.0, 1.0)) -> Tuple[np.ndarray, np.ndarray]:
    """Iso-surface of grid [nx,ny,nz] -> (verts [V,3] f32, tris [T,3] i32)."""
    lib = _lib()
    g = np.ascontiguousarray(grid, dtype=np.float32)
    o = np.asarray(origin, np.float32)
    s = np.asarray(spacing, np.float32)
    pv, pt = _FP(), _IP()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    ret = lib.marching_tets(g.ctypes.data_as(_FP), g.shape[0], g.shape[1], g.shape[2],
                            ctypes.c_float(iso), o.ctypes.data_as(_FP), s.ctypes.data_as(_FP),
                            ctypes.byref(pv), ctypes.byref(nv), ctypes.byref(pt), ctypes.byref(nt))
    if ret != 0:
        raise RuntimeError(f"marching_tets failed ({ret})")
    return _collect(lib, pv, nv, pt, nt)


def decimate(verts: np.ndarray, tris: np.ndarray, target_faces: int) -> Tuple[np.ndarray, np.ndarray]:
    """QEM edge-collapse decimation to about target_faces triangles."""
    if tris.shape[0] <= target_faces:
        return verts.astype(np.float32), tris.astype(np.int32)
    lib = _lib()
    v = np.ascontiguousarray(verts, np.float32)
    t = np.ascontiguousarray(tris, np.int32)
    pv, pt = _FP(), _IP()
    nv, nt = ctypes.c_int64(), ctypes.c_int64()
    ret = lib.decimate_qem(v.ctypes.data_as(_FP), v.shape[0], t.ctypes.data_as(_IP), t.shape[0],
                           int(target_faces), ctypes.byref(pv), ctypes.byref(nv),
                           ctypes.byref(pt), ctypes.byref(nt))
    if ret != 0:
        raise RuntimeError(f"decimate_qem failed ({ret})")
    return _collect(lib, pv, nv, pt, nt)

"""ctypes binding to the repo's native host library (`native/src/*.cpp`):
marching tetrahedra, the twin of the numpy path in `mesh/marching.py`.

Port of the marching half of `bundlesdf_tpu/native.py` (the rasterizer
binding waits for `mesh/render.py`). The library is built on first use with
`make -C native` into the git-ignored `native/build/`, through a private
build directory and an atomic rename, so concurrent first users never load
a half-written file. Without a toolchain the caller falls back to numpy.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libbundlesdf_native.so")

_lib = None
_tried = False
# marching_tet_run keeps its result in static storage until
# marching_tet_fetch: one caller at a time
_lock = threading.Lock()


def _build():
    tmp = f"build/tmp.{os.getpid()}.{threading.get_ident()}"
    subprocess.run(["make", "-C", _NATIVE_DIR, f"BUILD={tmp}"], check=True,
                   capture_output=True, timeout=300)
    os.replace(os.path.join(_NATIVE_DIR, tmp, os.path.basename(_LIB_PATH)),
               _LIB_PATH)
    os.rmdir(os.path.join(_NATIVE_DIR, tmp))


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH):
            try:
                _build()
            except (OSError, subprocess.SubprocessError) as e:
                logging.info(f"native build unavailable ({e}); using the "
                             "numpy marching path")
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            logging.info(f"native load failed ({e}); using the numpy "
                         "marching path")
            return None
        lib.marching_tet_run.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64)]
        lib.marching_tet_run.restype = None
        lib.marching_tet_fetch.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)]
        lib.marching_tet_fetch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def marching_tetrahedra_native(field, isolevel=0.0):
    """Native twin of mesh.marching.marching_tetrahedra (without the
    gradient-based winding fix, which the caller applies); returns
    (verts, faces) or None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    field = np.ascontiguousarray(field, np.float32)
    nx, ny, nz = field.shape
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    with _lock:
        lib.marching_tet_run(
            field.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nx, ny, nz, isolevel, ctypes.byref(nv), ctypes.byref(nf))
        verts = np.zeros((nv.value, 3), np.float64)
        faces = np.zeros((nf.value, 3), np.int64)
        if nv.value:
            lib.marching_tet_fetch(
                verts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return verts, faces

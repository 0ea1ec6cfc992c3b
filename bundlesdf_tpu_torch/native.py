"""ctypes binding to the repo's native host library (`native/src/*.cpp`):
the z-buffer rasterizer and marching tetrahedra, twins of the numpy paths
in `mesh/render.py` and `mesh/marching.py`.

Port of `bundlesdf_tpu/native.py`. The port builds its own copy of the
library at first use, with `make -C native BUILD=<private dir>`, through
`utils/build.py`, which renames the finished file into
`bundlesdf_tpu_torch/csrc/build/` under a name keyed by the sources, so the
loader never opens a library that is still being written (the JAX package
builds into `native/build/` in place). Without a toolchain the callers take
their numpy paths.
"""
from __future__ import annotations

import ctypes
import glob
import logging
import os
import subprocess
import threading

import numpy as np

from bundlesdf_tpu_torch.utils import build
from bundlesdf_tpu_torch.utils.build import BUILD_DIR

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_LIB_NAME = "libbundlesdf_native.so"

_lib = None
_tried = False
# marching_tet_run keeps its result in static storage until
# marching_tet_fetch: one caller at a time
_lock = threading.Lock()


def _sources():
    return [os.path.join(_NATIVE_DIR, "Makefile")] + sorted(
        glob.glob(os.path.join(_NATIVE_DIR, "src", "*")))


def library_path() -> str:
    """Where the port's build of the library lives: one file per version of
    `native/Makefile` and `native/src/*`."""
    return build.library_path("bundlesdf_native", _sources())


def _build():
    return build.build_so(
        "bundlesdf_native", _sources(),
        lambda tmp: (["make", "-C", _NATIVE_DIR, f"BUILD={tmp}"],
                     os.path.join(tmp, _LIB_NAME)))[0]


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            logging.info(f"native library unavailable ({e}); using the numpy "
                         "marching and rasterizer paths")
            return None
        lib.rasterize_mesh.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int, ctypes.c_int, ctypes.c_double,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float)]
        lib.rasterize_mesh.restype = None
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


def rasterize_native(vertices, faces, K, ob_in_cam, H, W, znear=0.001):
    """Native twin of mesh.render.rasterize; returns the same dict, or None
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    vertices = np.ascontiguousarray(vertices, np.float64)
    faces = np.ascontiguousarray(faces, np.int64)
    K = np.ascontiguousarray(K, np.float64)
    T = np.ascontiguousarray(ob_in_cam, np.float64)
    depth = np.zeros((H, W), np.float32)
    face_id = np.full((H, W), -1, np.int32)
    bary = np.zeros((H, W, 3), np.float32)
    lib.rasterize_mesh(
        vertices.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(vertices),
        faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(faces),
        K.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        T.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        H, W, znear,
        depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        face_id.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bary.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return {"depth": depth, "face_id": face_id, "bary": bary}


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

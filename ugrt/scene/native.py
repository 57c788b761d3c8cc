"""ctypes bindings for the native runtime (native/ugrt_native.cpp).

Fast-path scene loading and PPM writing.  The shared library is built
from the sources at first use (``make -C native``); without a C++
compiler the callers fall back to the pure-Python implementations.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libugrt_native.so")

_lib = None
_build_failed = False


def _build() -> bool:
    """Build the library with native/Makefile.  Each process builds under
    its own name and renames the result into place, so processes that
    build at once never load a half-written file."""
    tmp = f"libugrt_native.so.{os.getpid()}.tmp"
    try:
        subprocess.run(["make", "-s", "-C", _NATIVE_DIR, f"OUT={tmp}"],
                       check=True, capture_output=True)
    except (OSError, subprocess.CalledProcessError):
        return False
    os.replace(os.path.join(_NATIVE_DIR, tmp), _LIB_PATH)
    return True


def _load():
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        if _build_failed or not _build():
            _build_failed = True
            return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.ugrt_parse_obj.restype = ctypes.c_void_p
    lib.ugrt_parse_obj.argtypes = [ctypes.c_char_p]
    lib.ugrt_free_scene.argtypes = [ctypes.c_void_p]
    for fn in ("ugrt_num_vertices", "ugrt_num_faces", "ugrt_num_normals"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.ugrt_copy_vertices.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ugrt_copy_faces.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ugrt_copy_mat_index.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ugrt_copy_normals.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ugrt_parse_materials.restype = ctypes.c_int64
    lib.ugrt_parse_materials.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                         ctypes.c_int64]
    lib.ugrt_write_ppm.restype = ctypes.c_int
    lib.ugrt_write_ppm.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def parse_obj_fast(path: str):
    """Parse an OBJ into (vertices f32 [V,3], faces i32 [F,3],
    mat_index i32 [F]) via the native parser.  None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    h = lib.ugrt_parse_obj(path.encode())
    if not h:
        raise IOError(f"native parser failed on {path}")
    try:
        nv = lib.ugrt_num_vertices(h)
        nf = lib.ugrt_num_faces(h)
        vertices = np.empty((nv, 3), dtype=np.float32)
        faces = np.empty((nf, 3), dtype=np.int32)
        mat_index = np.empty((nf,), dtype=np.int32)
        if nv:
            lib.ugrt_copy_vertices(h, vertices.ctypes.data)
        if nf:
            lib.ugrt_copy_faces(h, faces.ctypes.data)
            lib.ugrt_copy_mat_index(h, mat_index.ctypes.data)
        return vertices, faces, mat_index
    finally:
        lib.ugrt_free_scene(h)


def parse_materials_fast(path: str):
    """Custom material file -> [M, 6] float32, or None if unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = lib.ugrt_parse_materials(path.encode(), None, 0)
    if n < 0:
        raise IOError(f"cannot open {path}")
    out = np.zeros((n, 6), dtype=np.float32)
    lib.ugrt_parse_materials(path.encode(), out.ctypes.data, n)
    return out


def write_ppm_fast(path: str, image_u8, flip: bool = False) -> bool:
    """Native buffered P3 writer.  Returns False if unavailable."""
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(image_u8, dtype=np.uint8)
    h, w, _ = img.shape
    rc = lib.ugrt_write_ppm(path.encode(), img.ctypes.data, w, h,
                            1 if flip else 0)
    if rc != 0:
        raise IOError(f"native PPM write failed: {path}")
    return True

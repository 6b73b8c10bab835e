"""ctypes bindings for the native host kernels (C++).

Builds mea_native.cpp with g++ at first use into the port's build
directory (utils/build.py), never into the package; falls back to the
numpy implementations in ops/mea.py and pipeline/progressive.py when no
toolchain is available. Set MUSCLE_TPU_NO_NATIVE=1 to force the numpy
path. `loaded()` says whether the library is in use.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.build import LibSpec, ensure_built, package_path

_lib = None
_failed = False


def native_spec() -> LibSpec:
    return LibSpec(name="muscle_native", compiler="g++",
                   flags=("-O3", "-march=native", "-shared", "-fPIC"),
                   sources=(package_path("native", "mea_native.cpp"),))


def get_lib():
    """The loaded shared library, or None if unavailable."""
    global _lib, _failed
    if _lib is not None:
        return _lib
    if _failed or os.environ.get("MUSCLE_TPU_NO_NATIVE"):
        return None
    try:
        path = ensure_built([native_spec()])["muscle_native"]
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError):
        _failed = True
        return None
    lib.mea_align.restype = ctypes.c_int64
    lib.mea_align.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
    lib.build_post_accumulate_csr.restype = None
    lib.build_post_accumulate_csr.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_int]
    _lib = lib
    return _lib


def loaded() -> bool:
    return get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def mea_align_native(post: np.ndarray):
    """(score, path) via the C++ kernel; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    lx, ly = post.shape
    post = np.ascontiguousarray(post, dtype=np.float32)
    rows = np.empty(2 * (ly + 1), dtype=np.float32)
    tb = np.empty(lx * ly, dtype=np.uint8)
    path_buf = ctypes.create_string_buffer(int(lx + ly) + 1)
    score = ctypes.c_float()
    n = lib.mea_align(_fptr(post), lx, ly, _fptr(rows),
                      tb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                      path_buf, ctypes.byref(score))
    if n < 0:
        return None
    return float(score.value), path_buf.raw[:n].decode()


def build_post_accumulate_csr_native(out: np.ndarray, vals: np.ndarray,
                                     cols: np.ndarray, rowptr: np.ndarray,
                                     ptc1: np.ndarray, ptc2: np.ndarray,
                                     transposed: bool) -> bool:
    """CSR accumulation into the column posterior; False if unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    assert out.dtype == np.float32 and out.flags.c_contiguous
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    rowptr = np.ascontiguousarray(rowptr, dtype=np.int64)
    ptc1 = np.ascontiguousarray(ptc1, dtype=np.uint32)
    ptc2 = np.ascontiguousarray(ptc2, dtype=np.uint32)
    lib.build_post_accumulate_csr(
        _fptr(out), out.shape[1], _fptr(vals),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rowptr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(rowptr) - 1,
        ptc1.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ptc2.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        1 if transposed else 0)
    return True

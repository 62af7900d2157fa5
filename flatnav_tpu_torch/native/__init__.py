"""ctypes bindings for the port's native host library.

Counterpart of flatnav_tpu/native/__init__.py over the port's own copy of
the C++ source (`csrc/flatnav_native.cpp`): Gorder / RCM reordering,
MatrixMarket parsing and .npy IO. `_build` compiles it with the host
compiler at first use into the git-ignored `_build/` directory.

Every entry point has a pure-Python counterpart in its caller (`reorder.py`,
`Index.build_graph_links`, numpy's own .npy IO), which the tests use as the
oracle and which runs where the machine has no C++ compiler at all: the
functions here then return None (False for `npy_write`). A build that was
attempted and failed raises with the compiler's output; nothing falls back
from a broken build. `available()` says which path is active.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from flatnav_tpu_torch import _build

_lib: Optional[ctypes.CDLL] = None
_no_compiler = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _no_compiler
    if _lib is not None or _no_compiler:
        return _lib
    if _build.host_compiler() is None:
        _no_compiler = True
        return None
    lib = _build.load("flatnav_native")  # raises if the build fails
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.fn_gorder.argtypes = [
        i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, i32p
    ]
    lib.fn_gorder.restype = ctypes.c_int
    lib.fn_rcm.argtypes = [i32p, ctypes.c_int64, ctypes.c_int64, i32p]
    lib.fn_rcm.restype = ctypes.c_int
    lib.fn_read_mtx.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i32p
    ]
    lib.fn_read_mtx.restype = ctypes.c_int64
    lib.fn_npy_header.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p,
    ]
    lib.fn_npy_header.restype = ctypes.c_int
    lib.fn_npy_read.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64
    ]
    lib.fn_npy_read.restype = ctypes.c_int
    lib.fn_npy_write.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
    ]
    lib.fn_npy_write.restype = ctypes.c_int
    _lib = lib
    return _lib


def available() -> bool:
    """True when the native library runs; False when the machine has no
    C++ compiler and the Python paths run instead."""
    return _load() is not None


def gorder(links: np.ndarray, n: int, window_size: int = 5) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    links = np.ascontiguousarray(links[:n], dtype=np.int32)
    perm = np.empty(n, np.int32)
    if lib.fn_gorder(links, n, links.shape[1], window_size, perm) != 0:
        return None
    return perm


def rcm_order(links: np.ndarray, n: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    links = np.ascontiguousarray(links[:n], dtype=np.int32)
    perm = np.empty(n, np.int32)
    if lib.fn_rcm(links, n, links.shape[1], perm) != 0:
        return None
    return perm


def read_mtx(path: str, n: int, m: int) -> Optional[np.ndarray]:
    """Dense [n, m] links of a MatrixMarket edge list; None when the file is
    not one the parser accepts (the caller's Python parser then names the
    fault)."""
    lib = _load()
    if lib is None:
        return None
    links = np.empty((n, m), np.int32)
    applied = lib.fn_read_mtx(path.encode(), n, m, links)
    if applied < 0:
        return None
    return links


_NPY_DESCRS = {
    "f4": (np.float32, b"<f4"),
    "u1": (np.uint8, b"|u1"),
    "i1": (np.int8, b"|i1"),
    "i4": (np.int32, b"<i4"),
}


def npy_read(path: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    n = ctypes.c_int64()
    d = ctypes.c_int64()
    dtype_buf = ctypes.create_string_buffer(8)
    if lib.fn_npy_header(path.encode(), ctypes.byref(n), ctypes.byref(d), dtype_buf) != 0:
        return None
    dtype, _ = _NPY_DESCRS[dtype_buf.value.decode()]
    out = np.empty((n.value, d.value), dtype)
    if lib.fn_npy_read(path.encode(), out.ctypes.data_as(ctypes.c_void_p), out.nbytes) != 0:
        return None
    return out


def npy_write(path: str, arr: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        return False
    if arr.ndim > 2:
        raise ValueError(
            f"npy_write handles 1-D/2-D arrays, got shape {arr.shape}"
        )
    arr = np.ascontiguousarray(arr)
    key = {"float32": "f4", "uint8": "u1", "int8": "i1", "int32": "i4"}.get(
        arr.dtype.name
    )
    if key is None:
        return False
    _, descr = _NPY_DESCRS[key]
    n, d = arr.shape if arr.ndim == 2 else (arr.shape[0], 1)
    return (
        lib.fn_npy_write(
            path.encode(),
            arr.ctypes.data_as(ctypes.c_void_p),
            n,
            d,
            descr,
            arr.itemsize,
        )
        == 0
    )

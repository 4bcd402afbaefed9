"""Native (C++) host-side components, bound via ctypes.

The reference's performance layer is Numba + CuPy (SURVEY.md §2.2); its
host-side data loading (ALIST parity-check matrices, fec.py:811) is pure
Python. Here the hot device path is JAX/XLA/Pallas, and the host-side
loaders that feed it are native C++: compiled lazily with the system
toolchain on first use, cached in the checkout's ``.native_build``, with a
pure-Python fallback so the package never hard-depends on a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_LIB_TRIED = False


class _AlistData(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int),
        ("m", ctypes.c_int),
        ("max_col", ctypes.c_int),
        ("max_row", ctypes.c_int),
        ("nnz", ctypes.c_longlong),
        ("rows", ctypes.POINTER(ctypes.c_int)),
        ("cols", ctypes.POINTER(ctypes.c_int)),
    ]


def _cache_dir() -> str:
    # the checkout's own build directory (listed in .gitignore): the
    # package writes nothing outside its checkout
    d = os.path.join(os.path.dirname(os.path.dirname(_SRC_DIR)), ".native_build")
    os.makedirs(d, exist_ok=True)
    return d


_SOURCES = ("alist.cpp", "gf2.cpp")


def _build_lib() -> str | None:
    """Compile the native sources into a cached shared library."""
    srcs = [os.path.join(_SRC_DIR, s) for s in _SOURCES]
    try:
        h = hashlib.sha256()
        for s in srcs:
            with open(s, "rb") as f:
                h.update(f.read())
        digest = h.hexdigest()[:16]
    except OSError:
        return None
    out = os.path.join(_cache_dir(), f"libnative-{digest}.so")
    if os.path.exists(out):
        return out
    # build into a temp file then rename: atomic under concurrent imports
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_cache_dir())
    os.close(fd)
    cmd = ["g++", "-O2", "-shared", "-fPIC", *srcs, "-o", tmp]
    try:
        subprocess.run(
            cmd, check=True, capture_output=True, timeout=120
        )
        os.replace(tmp, out)
        return out
    except (OSError, subprocess.SubprocessError):
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None


def _get_lib():
    global _LIB, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if os.environ.get("OPTICOMMPY_NO_NATIVE"):
        return None
    path = _build_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.alist_parse.argtypes = [ctypes.c_char_p]
        lib.alist_parse.restype = ctypes.POINTER(_AlistData)
        lib.alist_free.argtypes = [ctypes.POINTER(_AlistData)]
        lib.alist_free.restype = None
        lib.gf2_rref.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_long, ctypes.c_long,
        ]
        lib.gf2_rref.restype = ctypes.c_long
    except (OSError, AttributeError):
        return None
    _LIB = lib
    return _LIB


def native_available() -> bool:
    """Whether the native loader compiled and loaded on this host."""
    return _get_lib() is not None


def alist_edges(path):
    """Parse an ALIST file natively into its edge list.

    Returns ``(n, m, rows, cols)`` with ``rows``/``cols`` int32 arrays of the
    nonzero support of the (m, n) parity-check matrix, or ``None`` when the
    native library is unavailable or the file fails native validation (the
    caller falls back to the Python parser).
    """
    lib = _get_lib()
    if lib is None:
        return None
    ptr = lib.alist_parse(os.fsencode(path))
    if not ptr:
        return None
    try:
        d = ptr.contents
        nnz = int(d.nnz)
        rows = np.ctypeslib.as_array(d.rows, shape=(nnz,)).copy() if nnz else np.zeros(0, np.int32)
        cols = np.ctypeslib.as_array(d.cols, shape=(nnz,)).copy() if nnz else np.zeros(0, np.int32)
        return int(d.n), int(d.m), rows.astype(np.int32), cols.astype(np.int32)
    finally:
        lib.alist_free(ptr)


def gf2_rref(M):
    """Reduced row echelon form over GF(2), bit-packed native path.

    ``M`` is a (m, n) 0/1 array. Returns the uint8 rref (same pivot policy
    and therefore bit-identical output to the NumPy implementation in
    ``comm.fec.gauss_elim_gf2``), or ``None`` when the native library is
    unavailable.
    """
    lib = _get_lib()
    if lib is None:
        return None
    M = np.ascontiguousarray(np.asarray(M, dtype=np.uint8) % 2)
    m, n = M.shape
    if m == 0 or n == 0:
        return M
    packed = np.packbits(M, axis=1, bitorder="little")
    n_words = -(-n // 64)
    if packed.shape[1] != n_words * 8:
        packed = np.concatenate(
            [packed,
             np.zeros((m, n_words * 8 - packed.shape[1]), dtype=np.uint8)],
            axis=1,
        )
    words = np.ascontiguousarray(packed).view(np.uint64)
    lib.gf2_rref(
        words.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_long(m),
        ctypes.c_long(n),
    )
    return np.unpackbits(words.view(np.uint8), axis=1, count=n,
                         bitorder="little")

"""Loader for the repo's native sparse toolkit, ``csrc/sparsetools.cpp``
(the port's own copy of ``native.py``'s loader), and for the port's dense
host helper, ``nonlinearsolve_tpu_torch/csrc/densetools.cpp`` (Gauss–Jordan
for small systems in CPU tensors, ``gauss_jordan``).

The source is compiled as it is, with ``g++``, at first use into
``nonlinearsolve_tpu_torch/csrc/build/`` (through
``_backend.compile_shared``: the library's name carries a hash of the
source and the flags) and bound with ``ctypes``.  Bound: ``greedy_column_coloring``, ``rcm_ordering`` and
``ell_plan``.  A failed build raises with the compiler's output: the port
never falls back to the Python coloring or ELL loop on its own, and where
the JAX package's ``rcm_ordering`` and ``ell_plan`` return ``None`` without
their library, the port's raise.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from pathlib import Path

import numpy as np

from . import _backend

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "sparsetools.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib = None


def build() -> Path:
    """Compile ``csrc/sparsetools.cpp`` unless its library exists."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: csrc/sparsetools.cpp "
                           "cannot be built")
    return _backend.compile_shared(SOURCE, "sparsetools", "g++", gxx,
                                   GXX_FLAGS)


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.greedy_column_coloring.restype = ctypes.c_int32
            lib.greedy_column_coloring.argtypes = [
                i32p, i32p, ctypes.c_int32, ctypes.c_int32, i32p]
            lib.rcm_ordering.restype = ctypes.c_int32
            lib.rcm_ordering.argtypes = [i32p, i32p, ctypes.c_int32, i32p]
            lib.ell_plan.restype = ctypes.c_int32
            lib.ell_plan.argtypes = [
                i32p, i32p, ctypes.c_int32, ctypes.c_int32, i32p,
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int8)]
            _lib = lib
    return _lib


def _ptr(a, typ=ctypes.c_int32):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def greedy_column_coloring(indptr, indices, n_rows, n_cols) -> np.ndarray:
    """Native distance-2 greedy column coloring (columns conflict iff they
    share a row); returns int32 colors in [0, n_colors)."""
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    # a malformed pattern must fail here, not scatter out of bounds in C
    if indptr.shape != (n_rows + 1,) or indptr[-1] != indices.size:
        raise ValueError("indptr does not describe the indices")
    if indices.size and (indices.min() < 0 or indices.max() >= n_cols):
        raise ValueError(
            f"sparsity pattern column index out of range [0, {n_cols}): "
            f"min={indices.min()}, max={indices.max()}")
    colors = np.empty(n_cols, np.int32)
    n = get_lib().greedy_column_coloring(
        _ptr(indptr), _ptr(indices), np.int32(n_rows), np.int32(n_cols),
        _ptr(colors))
    if n < 0:
        raise ValueError(f"greedy_column_coloring refused the pattern "
                         f"(rc {n})")
    return colors


def rcm_ordering(indptr, indices, n) -> np.ndarray:
    """Reverse Cuthill–McKee ordering of the symmetrised square pattern:
    ``perm[new] = old`` (int32).  Raises if the library refuses it."""
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    if indptr.shape != (n + 1,) or indptr[-1] != indices.size:
        raise ValueError("indptr does not describe the indices")
    perm = np.empty(n, np.int32)
    rc = get_lib().rcm_ordering(_ptr(indptr), _ptr(indices), np.int32(n),
                                _ptr(perm))
    if rc != 0:
        raise ValueError(f"rcm_ordering refused the pattern (rc {rc})")
    return perm


def ell_plan(indptr, indices, n_rows):
    """The ELL layout of a CSR pattern: ``(width, cols, perm, valid)``, with
    ``width`` the longest row, ``cols`` (int32), ``perm`` (int64, the
    source nonzero of each slot) and ``valid`` (bool) of shape
    (n_rows, width); pad slots hold 0 / 0 / False.  One query call for the
    width, then one fill call, as the JAX loader does.  Raises if the
    library refuses the pattern."""
    indptr = np.ascontiguousarray(indptr, np.int32)
    indices = np.ascontiguousarray(indices, np.int32)
    if indptr.shape != (n_rows + 1,) or indptr[-1] != indices.size:
        raise ValueError("indptr does not describe the indices")
    lib = get_lib()
    width = lib.ell_plan(_ptr(indptr), _ptr(indices), np.int32(n_rows),
                         np.int32(0), None, None, None)
    if width < 0:
        raise ValueError(f"ell_plan refused the pattern (rc {width})")
    cols = np.zeros((n_rows, width), np.int32)
    perm = np.zeros((n_rows, width), np.int64)
    valid = np.zeros((n_rows, width), np.int8)
    rc = lib.ell_plan(_ptr(indptr), _ptr(indices), np.int32(n_rows),
                      np.int32(width), _ptr(cols), _ptr(perm, ctypes.c_int64),
                      _ptr(valid, ctypes.c_int8))
    if rc < 0:
        raise ValueError(f"ell_plan refused the pattern (rc {rc})")
    return width, cols, perm, valid.astype(bool)


DENSE_SOURCE = Path(__file__).resolve().parent / "csrc" / "densetools.cpp"
DENSE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_dense_lib = None


def get_dense_lib() -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/densetools.cpp``."""
    global _dense_lib
    with _lock:
        if _dense_lib is None:
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found on PATH: "
                                   "csrc/densetools.cpp cannot be built")
            lib = ctypes.CDLL(str(_backend.compile_shared(
                DENSE_SOURCE, "densetools", "g++", gxx, DENSE_FLAGS)))
            for fn in (lib.gauss_jordan_f64, lib.gauss_jordan_f32):
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_void_p]
            _dense_lib = lib
    return _dense_lib


def gauss_jordan(M):
    """Gauss–Jordan on the augmented matrix ``M = [A | B]`` (a contiguous
    f32 or f64 CPU tensor of n rows), in place: its last columns become
    ``X``."""
    import torch
    n, w = M.shape
    lib = get_dense_lib()
    fn = (lib.gauss_jordan_f64 if M.dtype == torch.float64
          else lib.gauss_jordan_f32)
    scratch = torch.empty(3 * w, dtype=M.dtype)
    fn(ctypes.c_void_p(M.data_ptr()), n, w,
       ctypes.c_void_p(scratch.data_ptr()))
    return M

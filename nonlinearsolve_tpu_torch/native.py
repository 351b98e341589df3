"""Loader for the repo's native sparse toolkit, ``csrc/sparsetools.cpp``
(the port's own copy of ``native.py``'s loader), and for the port's dense
host helper, ``nonlinearsolve_tpu_torch/csrc/densetools.cpp`` (Gauss–Jordan
for small systems in CPU tensors, ``gauss_jordan``).

The source is compiled as it is, with ``g++``, at first use into
``nonlinearsolve_tpu_torch/csrc/build/`` (through
``_backend.compile_shared``: the library's name carries a hash of the
source and the flags) and bound with ``ctypes``.  Bound:
``greedy_column_coloring``, ``rcm_ordering``, ``ell_plan``,
``band_offsets``, ``bandwidths``, ``amd_ordering``, ``sp_lu_solve`` and the
persistent factor ``SpLuFactor`` (``sp_lu_factor_*``).  A failed build
raises with the compiler's output: the port never falls back to the Python
coloring or ELL loop on its own, and where the JAX package's functions
return ``None`` without their library, the port's raise.
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
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.band_offsets.restype = ctypes.c_int32
            lib.band_offsets.argtypes = [i32p, i32p, ctypes.c_int32, i32p,
                                         ctypes.c_int32]
            lib.bandwidths.restype = ctypes.c_int32
            lib.bandwidths.argtypes = [i32p, i32p, ctypes.c_int32]
            lib.amd_ordering.restype = ctypes.c_int32
            lib.amd_ordering.argtypes = [i32p, i32p, ctypes.c_int32, i32p]
            lib.sp_lu_solve.restype = ctypes.c_int64
            lib.sp_lu_solve.argtypes = [i32p, i32p, f64p, ctypes.c_int32,
                                        i32p, f64p, f64p, ctypes.c_double]
            lib.sp_lu_factor_create.restype = ctypes.c_void_p
            lib.sp_lu_factor_create.argtypes = [
                i32p, i32p, f64p, ctypes.c_int32, i32p, ctypes.c_double,
                i64p]
            lib.sp_lu_refactor.restype = ctypes.c_int32
            lib.sp_lu_refactor.argtypes = [ctypes.c_void_p, f64p]
            lib.sp_lu_factor_solve.restype = ctypes.c_int32
            lib.sp_lu_factor_solve.argtypes = [ctypes.c_void_p, f64p, f64p]
            lib.sp_lu_factor_free.restype = None
            lib.sp_lu_factor_free.argtypes = [ctypes.c_void_p]
            lib.sp_lu_factor_sizes.restype = ctypes.c_int32
            lib.sp_lu_factor_sizes.argtypes = [ctypes.c_void_p, i64p, i64p]
            lib.sp_lu_factor_export.restype = ctypes.c_int32
            lib.sp_lu_factor_export.argtypes = [
                ctypes.c_void_p, i64p, i32p, f64p, i64p, i32p, f64p, f64p,
                i32p, i32p]
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



def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def _f64(a):
    return np.ascontiguousarray(a, np.float64)


def _null_i32():
    return ctypes.POINTER(ctypes.c_int32)()


def band_offsets(indptr, indices, n, cap=4096):
    """The distinct diagonal offsets ``col - row`` of a square pattern,
    ascending (int32), or ``None`` when there are more than ``cap`` of
    them or a column is out of range (the library's refusal)."""
    indptr, indices = _i32(indptr), _i32(indices)
    out = np.empty(cap, np.int32)
    count = get_lib().band_offsets(_ptr(indptr), _ptr(indices), np.int32(n),
                                   _ptr(out), np.int32(cap))
    if count < 0:
        return None
    return out[:count].copy()


def bandwidths(indptr, indices, n):
    """``(kl, ku)`` of a square pattern (the library packs them in one
    int32, 16 bits each, as the JAX package reads them)."""
    packed = get_lib().bandwidths(_ptr(_i32(indptr)), _ptr(_i32(indices)),
                                  np.int32(n))
    return packed >> 16, packed & 0xFFFF


def amd_ordering(indptr, indices, n):
    """Approximate-minimum-degree fill-reducing ordering (the AMD role in
    the reference's KLU path): ``perm[new] = old`` (int32), or ``None``
    when the library refuses the pattern."""
    indptr, indices = _i32(indptr), _i32(indices)
    if indices.size and (indices.min() < 0 or indices.max() >= n):
        raise ValueError("pattern column index out of range")
    perm = np.empty(max(n, 1), np.int32)
    rc = get_lib().amd_ordering(_ptr(indptr), _ptr(indices), np.int32(n),
                                _ptr(perm))
    return perm[:n] if rc == 0 else None


def sp_lu_solve(indptr, indices, data, b, perm=None, *,
                pivot_threshold=0.1):
    """One-shot sparse direct solve ``x = A⁻¹ b`` by the native
    Gilbert–Peierls LU with threshold partial pivoting on the symmetrically
    permuted pattern, in float64 on the host.  Returns ``(x, fill)`` with
    ``fill = nnz(L) + nnz(U)`` (-2: numerically singular)."""
    n = b.shape[0]
    indptr, indices = _i32(indptr), _i32(indices)
    data, b = _f64(data), _f64(b)
    x = np.empty(n, np.float64)
    perm_ptr = _null_i32() if perm is None else _ptr(_i32(perm))
    fill = get_lib().sp_lu_solve(
        _ptr(indptr), _ptr(indices), _ptr(data, ctypes.c_double),
        np.int32(n), perm_ptr, _ptr(b, ctypes.c_double),
        _ptr(x, ctypes.c_double), float(pivot_threshold))
    return x, int(fill)


class SpLuFactor:
    """Persistent native sparse LU: the symbolic analysis and the pivot
    order are computed once, later Newton steps refactor numerically only
    (the ``reuse_A_if_factorization`` role of the reference's linear-solve
    cache; KLU's symbolic/numeric split).  Each call holds the instance's
    lock."""

    def __init__(self, indptr, indices, n, perm=None, *,
                 pivot_threshold=0.1):
        self._lib = get_lib()
        self.n = int(n)
        self.indptr = _i32(indptr)
        self.indices = _i32(indices)
        self.perm = None if perm is None else _i32(perm)
        self.pivot_threshold = float(pivot_threshold)
        self.fill = None
        self._handle = None
        self._lock = threading.Lock()
        self.n_factor = 0          # full factorizations performed
        self.n_refactor = 0        # numeric-only refactorizations

    def _perm_ptr(self):
        return _null_i32() if self.perm is None else _ptr(self.perm)

    def _create(self, data):
        status = ctypes.c_int64(0)
        handle = self._lib.sp_lu_factor_create(
            _ptr(self.indptr), _ptr(self.indices),
            _ptr(data, ctypes.c_double), np.int32(self.n), self._perm_ptr(),
            self.pivot_threshold, ctypes.byref(status))
        if not handle:
            return int(status.value)       # -1 size error / -2 singular
        self._handle = handle
        self.fill = int(status.value)
        self.n_factor += 1
        return 0

    def _factorize_locked(self, data) -> int:
        if self._handle is not None:
            rc = int(self._lib.sp_lu_refactor(
                self._handle, _ptr(data, ctypes.c_double)))
            if rc == 0:
                self.n_refactor += 1
                return 0
            self._lib.sp_lu_factor_free(self._handle)
            self._handle = None
        return self._create(data)

    def _solve_locked(self, b):
        x = np.empty(self.n, np.float64)
        rc = int(self._lib.sp_lu_factor_solve(
            self._handle, _ptr(b, ctypes.c_double),
            _ptr(x, ctypes.c_double)))
        return x if rc == 0 else None

    def factorize(self, data) -> int:
        """(Re)factorize with new values on the fixed pattern: numeric-only
        when a factor exists, a fresh pivoting factorization when the reused
        pivot order degrades (rc -3) or meets an exact zero (rc -2).
        Returns 0 on success, -2 on singularity."""
        data = _f64(data)
        with self._lock:
            return self._factorize_locked(data)

    def solve(self, b):
        """``x = A⁻¹ b`` with the current factors; ``None`` when there is
        no factor or it is numerically singular."""
        b = _f64(b)
        with self._lock:
            if self._handle is None:
                return None
            return self._solve_locked(b)

    def factorize_solve(self, data, b):
        """Factorize and solve under one hold of the lock, so that two
        callers sharing a cached factor never solve with each other's
        values.  Returns x or ``None``."""
        data, b = _f64(data), _f64(b)
        with self._lock:
            if self._factorize_locked(data) != 0 or self._handle is None:
                return None
            return self._solve_locked(b)

    def export_factor(self):
        """The current factors in pivot space (``sp_lu_factor_export``):
        ``Lp``/``Lrow``/``Lval`` (strict lower, CSC, unit diagonal implied),
        ``Up``/``Urow``/``Uval`` (strict upper), ``Ud`` (the diagonal),
        ``in_perm``/``out_perm`` (``b̂ = b[in_perm]``; ``x[out_perm] = z``)
        and ``n_factor``; ``None`` when unfactorized.  The pattern parts
        hold across numeric-only refactorizations; a changed ``n_factor``
        means a re-pivot."""
        with self._lock:
            if self._handle is None:
                return None
            nl, nu = ctypes.c_int64(0), ctypes.c_int64(0)
            self._lib.sp_lu_factor_sizes(self._handle, ctypes.byref(nl),
                                         ctypes.byref(nu))
            nl, nu, n = int(nl.value), int(nu.value), self.n
            out = {"Lp": np.empty(n + 1, np.int64),
                   "Lrow": np.empty(nl, np.int32),
                   "Lval": np.empty(nl, np.float64),
                   "Up": np.empty(n + 1, np.int64),
                   "Urow": np.empty(nu, np.int32),
                   "Uval": np.empty(nu, np.float64),
                   "Ud": np.empty(n, np.float64),
                   "in_perm": np.empty(n, np.int32),
                   "out_perm": np.empty(n, np.int32)}
            i64, f64 = ctypes.c_int64, ctypes.c_double
            self._lib.sp_lu_factor_export(
                self._handle, _ptr(out["Lp"], i64), _ptr(out["Lrow"]),
                _ptr(out["Lval"], f64), _ptr(out["Up"], i64),
                _ptr(out["Urow"]), _ptr(out["Uval"], f64),
                _ptr(out["Ud"], f64), _ptr(out["in_perm"]),
                _ptr(out["out_perm"]))
            out["n_factor"] = self.n_factor
            return out

    def close(self):
        with self._lock:
            if self._handle is not None:
                self._lib.sp_lu_factor_free(self._handle)
                self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

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
            for fn in (lib.gauss_jordan_batch_f64, lib.gauss_jordan_batch_f32):
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_void_p]
            _dense_lib = lib
    return _dense_lib


def gauss_jordan(M):
    """Gauss–Jordan on the augmented matrix ``M = [A | B]`` (a contiguous
    f32 or f64 CPU tensor of n rows, or a batch of them, (batch, n, w)),
    in place: the last columns of each become its ``X``."""
    import torch
    if M.dim() not in (2, 3) or not M.is_contiguous() \
            or M.dtype not in (torch.float32, torch.float64):
        raise ValueError("gauss_jordan takes a contiguous f32/f64 (n, w) "
                         "or (batch, n, w) CPU tensor")
    n, w = M.shape[-2:]
    lib = get_dense_lib()
    f64 = M.dtype == torch.float64
    scratch = torch.empty(3 * w, dtype=M.dtype)
    if M.dim() == 2:
        fn = lib.gauss_jordan_f64 if f64 else lib.gauss_jordan_f32
        fn(ctypes.c_void_p(M.data_ptr()), n, w,
           ctypes.c_void_p(scratch.data_ptr()))
    else:
        fn = lib.gauss_jordan_batch_f64 if f64 else lib.gauss_jordan_batch_f32
        fn(ctypes.c_void_p(M.data_ptr()), M.shape[0], n, w,
           ctypes.c_void_p(scratch.data_ptr()))
    return M

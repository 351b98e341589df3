"""Generalized-diagonal (DIA) SpMV tier (the port of ``ops/spmv_dia.py``).

Stencil-born patterns have a fixed, small set of column−row offsets: the
512² two-component Brusselator has 11.  On them ``y = Σ_d data_d ⊙
shift(x, off_d)`` needs no index tables.  ``DiaPlan`` holds the offsets and
the CSR→(ndiag, n) repack, a static selection (K5's unit-data variant)
built at first use; ``matvec_packed`` is kernel K4.

Convention (as ``ops/sparse.DIA``): ``data[d, i] = A[i, i + off_d]``;
out-of-range slots are zero and K4 never reads them.
"""

from __future__ import annotations

import numpy as np

from .spmv import _unique_sorted, dia_spmv

# Plan acceptance, as the JAX package's: a cap on the diagonal count (each
# costs one pass over x and data however empty it is) and on the repack
# table (ndiag · n slots).
DIA_MAX_OFFSETS = 48
DIA_MAX_TABLE = 32 * 1024 * 1024


class DiaPlan:
    """Host-side plan: offsets + the CSR→(ndiag, n) repack selection."""

    def __init__(self, indptr, indices, n_rows, n_cols):
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self.supported = False
        self._sel = None
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        nnz = int(indptr[-1])
        self.nnz = nnz
        if n_rows != n_cols or n_rows == 0 or nnz == 0:
            return
        row_ids = np.repeat(np.arange(n_rows, dtype=np.int64),
                            np.diff(indptr))
        offs = indices - row_ids
        uniq = _unique_sorted(offs, -(n_rows - 1), n_cols - 1)
        if (len(uniq) > DIA_MAX_OFFSETS
                or len(uniq) * n_rows > DIA_MAX_TABLE):
            return
        self.offsets = tuple(int(o) for o in uniq)
        self.ndiag = len(uniq)
        self._dpos = np.searchsorted(uniq, offs).astype(np.int32)
        self._row_ids = row_ids.astype(np.int32)
        self.supported = True

    @property
    def sel(self):
        """The repack: slot (d, i) reads the CSR position of (i, i+off_d);
        pattern-absent slots are pads."""
        if self._sel is None:
            src = np.full((self.ndiag, self.n_rows), self.nnz, np.int64)
            src[self._dpos, self._row_ids] = np.arange(self.nnz)
            from .selection import StaticSelection
            self._sel = StaticSelection(src.reshape(-1), self.nnz)
        return self._sel

    def pack(self, data):
        """CSR-ordered data (nnz,) -> (ndiag, n) diagonal-major."""
        return self.sel.apply(data).reshape(self.ndiag, self.n_rows)

    def matvec_packed(self, dd, x):
        """y[i] = Σ_d dd[d, i] · x[i + off_d] (kernel K4)."""
        return dia_spmv(dd, self.offsets, x)

    def rmatvec_packed(self, dd, y):
        """Aᵀ y (the plain shifted chain of ``DIA.rmatvec``)."""
        from .sparse import DIA
        return DIA(dd, self.offsets, (self.n_rows, self.n_cols)).rmatvec(y)


_DIA_PLAN_CACHE: dict = {}


def dia_plan_for(indptr, indices, n_rows, n_cols) -> DiaPlan:
    from .spmv import pattern_key
    key = pattern_key(indptr, indices, n_rows, n_cols)
    plan = _DIA_PLAN_CACHE.get(key)
    if plan is None:
        plan = DiaPlan(indptr, indices, int(n_rows), int(n_cols))
        _DIA_PLAN_CACHE[key] = plan
    return plan


def dia_spmv_staged(plan: DiaPlan, data):
    """Staged closure: repack once, one K4 launch per matvec."""
    dd = plan.pack(data)

    def mv(x):
        return plan.matvec_packed(dd, x)
    return mv

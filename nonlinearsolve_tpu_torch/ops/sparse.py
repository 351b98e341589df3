"""Sparse matrix containers (the port of ``ops/sparse.py``): ``CSR`` and
``DIA``.  ELL and BSR are ROADMAP A.19's remainder.

``CSR``: the pattern (``indptr``, ``indices``) is a static host array, as
the JAX package's ``jac_prototype`` is; ``data`` is a tensor on the device
(``None`` for a pattern alone).  ``matvec`` and ``matvec_fn`` go through the
JAX package's tiers (``ops/spmv.py``): K4 on "dia", K7 on "stream", K8 on
"scatter", K5 on "resident" and where no tier fits.  The pattern's tier and
its int32 device copies are worked out once (the copies once per device)
and shared by every ``with_data`` copy.

``DIA``: ``data[d, i] = A[i, i + offsets[d]]``, (ndiag, n) on the device;
``matvec`` is K4 and reads in-band slots only.
"""

from __future__ import annotations

import numpy as np
import torch

from .spmv import csr_spmv, csr_spmv_staged, dia_spmv, select_spmv_plan


class CSR:
    """Compressed sparse row with a static host pattern."""

    def __init__(self, data, indices, indptr, shape, _shared=None):
        self.data = data
        self.indices = np.asarray(indices, np.int32)
        self.indptr = np.asarray(indptr, np.int32)
        self.shape = tuple(int(s) for s in shape)
        # what depends on the pattern alone: {"tier": ..., device: tables}
        self._shared = {} if _shared is None else _shared

    @property
    def nnz(self):
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def from_pattern(rows, cols, shape, data=None):
        """Build from a COO pattern (host); entries are sorted by (row, col),
        and ``data``, when given, is permuted with them."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        order = np.lexsort((cols, rows))
        rows, cols = rows[order], cols[order]
        counts = np.bincount(rows, minlength=shape[0])
        indptr = np.concatenate([[0], np.cumsum(counts)])
        if data is not None:
            data = torch.as_tensor(data)
            data = data[torch.as_tensor(order, device=data.device)]
        return CSR(data, cols, indptr, shape)

    def with_data(self, data):
        return CSR(data, self.indices, self.indptr, self.shape, self._shared)

    @property
    def row_ids(self):
        """nnz-length row index per entry (host, static)."""
        return np.repeat(np.arange(self.shape[0], dtype=np.int32),
                         np.diff(self.indptr))

    @property
    def tier(self):
        """``(tier, plan, perm, pinv, dperm)`` of ``select_spmv_plan`` for
        this pattern (once)."""
        if "tier" not in self._shared:
            self._shared["tier"] = select_spmv_plan(self.indptr, self.indices,
                                                    *self.shape)
        return self._shared["tier"]

    def perm_tables(self, device):
        """The tier's ``(perm, pinv, dperm)`` as int64 tensors on
        ``device`` (cached; the tier must carry a reorder)."""
        key = ("perm", torch.device(device))
        if key not in self._shared:
            _tier, _plan, *perms = self.tier
            self._shared[key] = tuple(torch.as_tensor(a, device=key[1])
                                      for a in perms)
        return self._shared[key]

    def device_tables(self, device):
        """``(indptr, indices)`` as int32 tensors on ``device`` (cached)."""
        key = torch.device(device)
        if key not in self._shared:
            self._shared[key] = (torch.as_tensor(self.indptr, device=key),
                                 torch.as_tensor(self.indices, device=key))
        return self._shared[key]

    def todense(self):
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        rows = torch.as_tensor(self.row_ids, device=out.device).long()
        cols = torch.as_tensor(self.indices, device=out.device).long()
        out[rows, cols] = self.data
        return out

    def matvec(self, x):
        return csr_spmv(self, x)

    def matvec_fn(self):
        """Staged matvec closure for repeated application (Krylov loops)."""
        return csr_spmv_staged(self)

    def diagonal(self):
        """The main diagonal (for Jacobi preconditioning)."""
        row_ids = self.row_ids
        is_diag = np.nonzero(self.indices == row_ids)[0]
        dev = self.data.device
        out = torch.zeros(self.shape[0], dtype=self.data.dtype, device=dev)
        return out.index_add_(
            0, torch.as_tensor(row_ids[is_diag], device=dev).long(),
            self.data[torch.as_tensor(is_diag, device=dev)])

    def __repr__(self):
        return f"CSR(shape={self.shape}, nnz={self.nnz})"


class DIA:
    """Banded (diagonal) storage: ``offsets`` static (ascending), ``data``
    (ndiag, n) with ``data[d, i] = A[i, i + offsets[d]]``."""

    def __init__(self, data, offsets, shape):
        self.data = data
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(int(s) for s in shape)

    @property
    def nnz(self):
        n = self.shape[0]
        return sum(max(n - abs(o), 0) for o in self.offsets)

    def with_data(self, data):
        return DIA(data, self.offsets, self.shape)

    def matvec(self, x):
        return dia_spmv(self.data, self.offsets, x)

    def rmatvec(self, y):
        """Aᵀ y: the shifted chain with data and vector shifted together
        by −off (entry A[i, i+off] lands at output i+off); the valid region
        only, as ``matvec``."""
        n = self.shape[0]
        out = None
        for d, off in enumerate(self.offsets):
            if off == 0:
                seg = self.data[d] * y
            elif abs(off) >= n:
                seg = torch.zeros_like(y)
            elif off > 0:
                seg = torch.cat([y.new_zeros(off),
                                 self.data[d, :n - off] * y[:n - off]])
            else:
                seg = torch.cat([self.data[d, -off:] * y[-off:],
                                 y.new_zeros(-off)])
            out = seg if out is None else out + seg
        return torch.zeros_like(y) if out is None else out

    def diagonal(self):
        if 0 not in self.offsets:
            return torch.zeros(self.shape[0], dtype=self.data.dtype,
                               device=self.data.device)
        return self.data[self.offsets.index(0)]

    def todense(self):
        n, m = self.shape
        out = torch.zeros((n, m), dtype=self.data.dtype,
                          device=self.data.device)
        for d, off in enumerate(self.offsets):
            if abs(off) >= n:
                continue
            if off >= 0:
                idx = torch.arange(0, n - off, device=out.device)
                out[idx, idx + off] = self.data[d, :n - off]
            else:
                idx = torch.arange(-off, n, device=out.device)
                out[idx, idx + off] = self.data[d, -off:]
        return out

    def __repr__(self):
        return f"DIA(shape={self.shape}, n_diags={len(self.offsets)})"

"""Sparse matrix containers (the port of ``ops/sparse.py``): ``CSR``,
``ELL``, ``DIA`` and ``BSR``, and the polymorphic ``spmv``.

``CSR``: the pattern (``indptr``, ``indices``) is a static host array, as
the JAX package's ``jac_prototype`` is; ``data`` is a tensor on the device
(``None`` for a pattern alone).  ``matvec`` and ``matvec_fn`` go through the
JAX package's tiers (``ops/spmv.py``): K4 on "dia", K7 on "stream", K8 on
"scatter", K5 on "resident" and where no tier fits.  The pattern's tier and
its int32 device copies are worked out once (the copies once per device)
and shared by every ``with_data`` copy.  ``rmatvec`` is the JAX package's
``segment_sum`` route (the one it takes off the TPU), as ``index_add_``.

``ELL``: padded rows, ``data`` (n_rows, width) on the device, ``cols`` and
``valid`` static on the host; ``CSR.to_ell`` plans it with the native
``ell_plan``.

``DIA``: ``data[d, i] = A[i, i + offsets[d]]``, (ndiag, n) on the device;
``matvec`` is K4 and reads in-band slots only.

``BSR``: dense b×b blocks, ``data`` (nblocks, b, b) on the device, the block
pattern static on the host.  ``matvec`` on the card is K5 on the expanded
scalar pattern (what the JAX package's ``BSR.matvec`` runs on the TPU); the
multi-RHS product is K6 (``ops/spmv.bsr_spmm``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _backend
from .spmv import (DiaFunction, bsr_route, bsr_scalar_pattern, bsr_spmv,
                   csr_spmv, csr_spmv_staged, select_spmv_plan)


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
    def from_dense(A, device=None):
        """The nonzeros of a dense host matrix, row by row, as data on
        ``device`` (the card by default)."""
        A = np.asarray(A)
        mask = A != 0
        indptr = np.concatenate([[0], np.cumsum(mask.sum(axis=1))])
        return CSR(torch.as_tensor(A[mask],
                                   device=_backend.resolve_device(device)),
                   np.nonzero(mask)[1], indptr, A.shape)

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

    def row_table(self, device):
        """``row_ids`` as an int32 tensor on ``device`` (cached)."""
        key = ("rows", torch.device(device))
        if key not in self._shared:
            self._shared[key] = torch.as_tensor(self.row_ids, device=key[1])
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

    def rmatvec(self, y):
        """Aᵀ y: the products with y[row], summed by column with
        ``index_add_`` (the JAX package's ``segment_sum`` route)."""
        return self.rmatvec_fn()(y)

    def rmatvec_fn(self):
        """Staged transpose-matvec closure (the row and column tables on
        the data's device, cached with the pattern)."""
        key = ("rmv", self.data.device)
        if key not in self._shared:
            self._shared[key] = (
                torch.as_tensor(self.row_ids, device=key[1]).long(),
                torch.as_tensor(self.indices, device=key[1]).long())
        rows, cols = self._shared[key]
        data, m = self.data, self.shape[1]

        def rmv(y):
            return torch.zeros(m, dtype=y.dtype, device=y.device).index_add_(
                0, cols, data * y.index_select(0, rows))
        return rmv

    def to_ell(self):
        """The padded-row layout (``native.ell_plan``); pad slots hold 0."""
        from ..native import ell_plan
        n = self.shape[0]
        width, cols, perm, valid = ell_plan(self.indptr, self.indices, n)
        dev = self.data.device
        data = self.data[torch.as_tensor(perm.reshape(-1), device=dev)]
        data = torch.where(torch.as_tensor(valid, device=dev),
                           data.reshape(n, width), 0.0)
        return ELL(data, cols, valid, self.shape)

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


class ELL:
    """Padded-row (ELLPACK) layout: ``data`` (n_rows, width) on the device;
    ``cols`` and ``valid`` (n_rows, width) static on the host."""

    def __init__(self, data, cols, valid, shape, _shared=None):
        self.data = data
        self.cols = np.asarray(cols, np.int32)
        self.valid = np.asarray(valid, bool)
        self.shape = tuple(int(s) for s in shape)
        self._shared = {} if _shared is None else _shared

    @property
    def width(self):
        return self.cols.shape[1]

    def with_data(self, data):
        return ELL(data, self.cols, self.valid, self.shape, self._shared)

    def _tables(self, device):
        """``cols`` (int64) and ``valid`` on ``device`` (cached)."""
        key = torch.device(device)
        if key not in self._shared:
            self._shared[key] = (torch.as_tensor(self.cols, device=key).long(),
                                 torch.as_tensor(self.valid, device=key))
        return self._shared[key]

    def matvec(self, x):
        """Gather x by slot, then the row sums over the valid slots only
        (a pad slot adds nothing, whatever x holds at its column 0)."""
        cols, valid = self._tables(x.device)
        prod = self.data * x[cols]
        return torch.where(valid, prod, 0.0).sum(dim=1)

    def todense(self):
        cols, valid = self._tables(self.data.device)
        out = torch.zeros(self.shape, dtype=self.data.dtype,
                          device=self.data.device)
        rows = torch.arange(self.shape[0], device=out.device)
        rows = rows[:, None].expand(-1, self.width)
        return out.index_put_((rows.reshape(-1), cols.reshape(-1)),
                              torch.where(valid, self.data, 0.0).reshape(-1),
                              accumulate=True)

    def __repr__(self):
        return f"ELL(shape={self.shape}, width={self.width})"


class DIA:
    """Banded (diagonal) storage: ``offsets`` static (ascending), ``data``
    (ndiag, n) with ``data[d, i] = A[i, i + offsets[d]]``."""

    def __init__(self, data, offsets, shape):
        self.data = data
        self.offsets = tuple(int(o) for o in offsets)
        self.shape = tuple(int(s) for s in shape)

    @staticmethod
    def from_csr(csr: CSR) -> "DIA":
        """One diagonal for each distinct offset ``col − row`` of the
        pattern (ascending), filled by one ``index_put_``; a duplicate
        (row, col) keeps one of its values, as in the JAX package."""
        row_ids = csr.row_ids.astype(np.int64)
        offsets, which = np.unique(csr.indices.astype(np.int64) - row_ids,
                                   return_inverse=True)
        dev = csr.data.device
        data = torch.zeros((len(offsets), csr.shape[0]), dtype=csr.data.dtype,
                           device=dev)
        data[torch.as_tensor(which.reshape(-1), device=dev),
             torch.as_tensor(row_ids, device=dev)] = csr.data
        return DIA(data, offsets, csr.shape)

    @property
    def nnz(self):
        n = self.shape[0]
        return sum(max(n - abs(o), 0) for o in self.offsets)

    def with_data(self, data):
        return DIA(data, self.offsets, self.shape)

    def matvec(self, x):
        """``A·x`` on K4; differentiable in the data and in x
        (``DiaFunction``: the transposed product on K4 too)."""
        return DiaFunction.apply(self.data, x, tuple(self.offsets))

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


class BSR:
    """Block compressed sparse row: dense b×b blocks on a sparse block
    graph (multi-component couplings: FEM, multi-species reaction
    networks).  ``data`` (nblocks, b, b) on the device; ``indices`` and
    ``indptr`` the static block pattern on the host."""

    def __init__(self, data, indices, indptr, shape, blocksize,
                 _shared=None):
        self.data = data
        self.indices = np.asarray(indices, np.int32)
        self.indptr = np.asarray(indptr, np.int32)
        self.shape = tuple(int(s) for s in shape)
        self.blocksize = int(blocksize)
        # what depends on the pattern alone: device tables by device
        self._shared = {} if _shared is None else _shared

    @property
    def nnz(self):
        return int(self.indices.shape[0]) * self.blocksize ** 2

    def with_data(self, data):
        return BSR(data, self.indices, self.indptr, self.shape,
                   self.blocksize, self._shared)

    @property
    def block_row_ids(self):
        n_brows = self.shape[0] // self.blocksize
        return np.repeat(np.arange(n_brows, dtype=np.int32),
                         np.diff(self.indptr))

    @staticmethod
    def from_csr(csr: CSR, blocksize: int) -> "BSR":
        """Reblock a CSR matrix: the host symbolic pass of the JAX package
        (blocks sorted by (block row, block column)), then one
        ``index_put_`` of the data.  A pattern with a duplicate (row, col)
        keeps one of its values, in an order CUDA does not fix; the
        patterns of the sparse-Jacobian plan have none."""
        n, m = csr.shape
        b = int(blocksize)
        if n % b or m % b:
            raise ValueError(f"shape {csr.shape} not divisible by "
                             f"blocksize {b}")
        row_ids = csr.row_ids.astype(np.int64)
        cols = csr.indices.astype(np.int64)
        keys = (row_ids // b) * (m // b) + cols // b
        uniq, inv = np.unique(keys, return_inverse=True)
        counts = np.bincount(uniq // (m // b), minlength=n // b)
        indptr = np.concatenate([[0], np.cumsum(counts)])
        dev = csr.data.device
        data = torch.zeros((len(uniq), b, b), dtype=csr.data.dtype,
                           device=dev)
        data[tuple(torch.as_tensor(a, device=dev)
                   for a in (inv.reshape(-1), row_ids % b, cols % b))] = \
            csr.data
        return BSR(data, uniq % (m // b), indptr, csr.shape, b)

    def device_tables(self, device):
        """``(indptr, indices)`` as int32 tensors and ``(indices,
        block_row_ids)`` as int64 tensors on ``device`` (cached), after a
        check that the block pattern fits the shape."""
        key = torch.device(device)
        if key not in self._shared:
            nbr, nbc = self.shape[0] // self.blocksize, \
                self.shape[1] // self.blocksize
            if (self.indptr.shape != (nbr + 1,)
                    or self.indptr[-1] != self.indices.size):
                raise ValueError("indptr does not describe the blocks")
            if self.indices.size and (self.indices.min() < 0
                                      or self.indices.max() >= nbc):
                raise ValueError(f"block column out of range [0, {nbc})")
            cols = torch.as_tensor(self.indices, device=key)
            self._shared[key] = (
                torch.as_tensor(self.indptr, device=key), cols, cols.long(),
                torch.as_tensor(self.block_row_ids, device=key).long())
        return self._shared[key]

    def scalar_tables(self, device):
        """The expanded scalar pattern's ``(indptr, indices)`` as int32
        tensors (its K5 route's, ``bsr_route``) and its take order as int64,
        on ``device`` (cached)."""
        key = ("scalar", torch.device(device))
        if key not in self._shared:
            indptr, _indices, take = bsr_scalar_pattern(self)
            if indptr[-1] > 2 ** 31 - 1:
                raise ValueError(f"{indptr[-1]} scalar nonzeros exceed the "
                                 f"int32 tables of K5")
            self._shared[key] = (
                *bsr_route(self).pattern.device_tables(key[1]),
                torch.as_tensor(take, device=key[1]))
        return self._shared[key]

    def matvec(self, x):
        """``A·x``: K5 on the expanded scalar pattern on the card (the JAX
        package's TPU route, ``ops/spmv.bsr_spmv``); on the CPU the gather,
        the batched block product and ``index_add_`` by block row (its
        route off the TPU)."""
        if x.device.type != "cpu":
            return bsr_spmv(self, x)
        b = self.blocksize
        _indptr, _indices, cols, brow = self.device_tables(x.device)
        prods = torch.einsum("nij,nj->ni", self.data,
                             x.reshape(-1, b).index_select(0, cols))
        out = torch.zeros((self.shape[0] // b, b), dtype=prods.dtype,
                          device=x.device)
        return out.index_add_(0, brow, prods).reshape(self.shape[0])

    def rmatvec(self, y):
        """Aᵀ y: each block transposed against y's block row, summed by
        block column."""
        b = self.blocksize
        _indptr, _indices, cols, brow = self.device_tables(y.device)
        prods = torch.einsum("nji,nj->ni", self.data,
                             y.reshape(-1, b).index_select(0, brow))
        out = torch.zeros((self.shape[1] // b, b), dtype=prods.dtype,
                          device=y.device)
        return out.index_add_(0, cols, prods).reshape(self.shape[1])

    def diagonal(self):
        """The main diagonal, from the blocks whose column is their row (a
        block row without one contributes nothing: the result is then
        shorter than n, as in the JAX package)."""
        return torch.diagonal(self.diag_blocks(), dim1=1,
                              dim2=2).reshape(-1)

    def diag_blocks(self):
        """The blocks whose block column is their block row, (k, b, b) in
        block order — k = n / b when every block row has one; feeds
        block-Jacobi."""
        ids = np.nonzero(self.indices == self.block_row_ids)[0]
        return self.data[torch.as_tensor(ids, device=self.data.device)]

    def todense(self):
        b = self.blocksize
        dev = self.data.device
        rr = torch.arange(b, device=dev)
        brow = torch.as_tensor(self.block_row_ids, device=dev).long()
        bcol = torch.as_tensor(self.indices, device=dev).long()
        rows = (brow * b)[:, None, None] + rr[None, :, None]
        cols = (bcol * b)[:, None, None] + rr[None, None, :]
        out = torch.zeros(self.shape, dtype=self.data.dtype, device=dev)
        out[rows.expand(-1, b, b), cols.expand(-1, b, b)] = self.data
        return out

    def __repr__(self):
        return (f"BSR(shape={self.shape}, blocksize={self.blocksize}, "
                f"nblocks={len(self.indices)})")


def spmv(A, x):
    """Polymorphic SpMV: a sparse container's ``matvec``, else ``A @ x``."""
    if isinstance(A, (CSR, ELL, DIA, BSR)):
        return A.matvec(x)
    return A @ x

"""The band-ELL SpMV tier, kernel K7 (the port of
``ops/pallas_spmv_stream.py``).

The JAX package's "stream" tier takes patterns with bounded diagonal-band
structure at any size: stencils, banded matrices, and what RCM makes
banded.  Its plan slots each row's nonzeros by diagonal-offset band, bands
ascending and, within a band, by column rank, so that every TPU window is
affine in the grid index.  ``BandPlan`` keeps that plan's acceptance as it
is (the band clustering, the sub-slots, the slot and padding caps, the
window groups, ``F`` and the coverage loop that decides ``ok``), so the
port's tier is the JAX package's.  The TPU's window-local packed indices
are not built; the port's tables are

- ``cols``: (w, n_pad) int32, slot-major, −1 in pad slots;
- ``pos``: the slot → CSR-position map, ``nnz`` in pad slots, which
  ``pack_data`` applies with one launch of K5's selection
  (``gather_select``) once per Jacobian, as the DIA repack does.

K7 ``band_spmv_packed(cols, data, x, n_rows)`` (``csrc/spmv.cu``) replaces
``ops/pallas_spmv_stream.py`` ``_band_spmv_call`` (``band_spmv_pallas``,
``band_spmv_staged``).  One thread per row walks its w slots in slot order,
which is the row's sorted column order, so its sum is taken in K5's order.
A pad slot is skipped, never multiplied by 0: where the JAX kernel
multiplies a pad's zero data by x at its window's first position, the two
differ only when that x is not finite.  The JAX package's custom VJP is
``ops/spmv.py``'s ``SpmvFunction`` on the "stream" route (K7 on Aᵀ's band
plan, or the segment-sum route when no band plan fits Aᵀ).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _backend
from .selection import StaticSelection
from .spmv import (LANES, ROWS_PER_TILE, SUBLANES, _SUFFIX, _check, _lib,
                   _fits_int32, _round_up, _unique_sorted, _value_dtype,
                   pattern_key)

# The JAX package's structural caps of the band plan.
MAX_BAND_SLOTS = 48
MAX_BANDS = 48
PAD_RATIO_CAP = 3.0
MAX_F_TILES = 512
MAX_GROUPS = 8
BAND_WIDTH = 1024


def _rows_sorted(indptr, indices) -> bool:
    """True when every row's columns are ascending."""
    if indices.size < 2:
        return True
    rising = np.diff(indices) >= 0
    rising[indptr[1:-1][(indptr[1:-1] > 0)
                        & (indptr[1:-1] < indices.size)] - 1] = True
    return bool(rising.all())


class BandPlan:
    """The JAX package's band-ELL plan for one pattern (acceptance and
    cost fields: ``w``, ``bands`` as (band_lo, band_hi, nslots, slot_base,
    span, group), ``group_lo_t``, ``F``, ``n_pad``, ``ok``), with the port's
    ``cols`` and ``pos`` tables when ``ok``."""

    def __init__(self, indptr, indices, n_rows, n_cols):
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.ok = False
        counts = np.diff(indptr)
        nnz = len(indices)
        self.nnz = nnz
        if nnz == 0 or n_rows == 0:
            return
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
        # per-row sorted column order (``order0``: sorted position -> CSR
        # position); the sort is skipped when the columns are sorted already
        if _rows_sorted(indptr, indices):
            order0 = None
        else:
            # lexsort((indices, rows)) as one stable sort of a combined key
            order0 = np.argsort(rows * max(n_cols, 1) + indices,
                                kind="stable")
            indices = indices[order0]
        offs = indices - rows

        # greedy band clustering of the distinct diagonal offsets
        uo = _unique_sorted(offs, -(n_rows - 1), max(n_cols - 1, 0))
        band_lo, band_hi = [], []
        i = 0
        while i < len(uo) and len(band_lo) <= MAX_BANDS:
            lo = uo[i]
            j = int(np.searchsorted(uo, lo + BAND_WIDTH, side="left"))
            band_lo.append(int(lo))
            band_hi.append(int(uo[j - 1]))
            i = j
        K = len(band_lo)
        if K > MAX_BANDS:
            return
        band_lo_a = np.asarray(band_lo, np.int64)
        band_id = np.searchsorted(band_lo_a, offs, side="right") - 1
        del offs

        # rank within each row's band run ((row, band) runs are contiguous
        # in the sorted order)
        key = rows * K + band_id
        first = np.concatenate([[0], np.flatnonzero(np.diff(key)) + 1]) \
            if nnz > 1 else np.zeros(1, np.int64)
        del key
        run_start = np.zeros(nnz, np.int64)
        run_start[first] = first
        run_start = np.maximum.accumulate(run_start)
        rank = np.arange(nnz, dtype=np.int64) - run_start
        del run_start

        m_k = np.zeros(K, np.int64)
        np.maximum.at(m_k, band_id, rank + 1)
        w = int(m_k.sum())
        n_pad = _round_up(max(n_rows, 1), ROWS_PER_TILE)
        if w > MAX_BAND_SLOTS or w * n_pad > PAD_RATIO_CAP * nnz + 4096 * w:
            return
        slot_base = np.concatenate([[0], np.cumsum(m_k)])[:-1]
        slots = slot_base[band_id] + rank
        del rank, band_id

        ntiles = n_pad // ROWS_PER_TILE
        # window groups: bands far apart in column space (periodic wraps)
        # stream their own x blocks on the TPU
        group_lo_t, group_hi_edge, band_gid = [], [], []
        for k in range(K):
            lo_t_k = band_lo[k] // BAND_WIDTH
            hi_edge_k = (BAND_WIDTH - 1 + band_hi[k]) // BAND_WIDTH + 1
            if (group_lo_t
                    and hi_edge_k - group_lo_t[-1] + 1 <= MAX_F_TILES):
                group_hi_edge[-1] = max(group_hi_edge[-1], hi_edge_k)
            else:
                group_lo_t.append(lo_t_k)
                group_hi_edge.append(hi_edge_k)
            band_gid.append(len(group_lo_t) - 1)
        if len(group_lo_t) > MAX_GROUPS:
            return
        F = max(hi - lo + 1 for lo, hi in zip(group_lo_t, group_hi_edge))
        if F > MAX_F_TILES:
            return
        self.F = F
        self.group_lo_t = [int(v) for v in group_lo_t]
        spans = [int((LANES - 1 + band_hi[k] - band_lo[k]) // BAND_WIDTH) + 2
                 for k in range(K)]
        self.bands = [(band_lo[k], band_hi[k], int(m_k[k]),
                       int(slot_base[k]), spans[k], band_gid[k])
                      for k in range(K)]
        self.w = w
        self.n_pad = n_pad
        self.ntiles = ntiles
        # the JAX plan's coverage proof: every walked window must fall in
        # its group's dual block, else F grows by 8 (four tries)
        tt = np.arange(ntiles, dtype=np.int64)
        for _ in range(4):
            okc = True
            F = self.F
            for (b_lo, _b_hi, _ns, _sb, span, gid) in self.bands:
                base = (np.maximum(tt + self.group_lo_t[gid], 0) // F) * F
                for j in (0, SUBLANES - 1):
                    wsv = np.maximum(
                        (ROWS_PER_TILE * tt + LANES * j + b_lo)
                        // BAND_WIDTH, 0)
                    if ((wsv < base).any()
                            or (wsv + span > base + 2 * F).any()):
                        okc = False
            if okc:
                break
            self.F += 8
        else:
            return
        if self.F > MAX_F_TILES:
            return

        # the port's tables: columns and CSR positions by (slot, row)
        cols = np.full((w, n_pad), -1, np.int32)
        cols[slots, rows] = indices
        pos = np.full((w, n_pad), nnz, np.int32)
        pos[slots, rows] = (np.arange(nnz, dtype=np.int32) if order0 is None
                            else order0)
        self.cols = cols
        self.pos = pos.reshape(-1)
        self._sel = None
        self._tables: dict = {}
        self.ok = True

    @property
    def supported(self) -> bool:
        return self.ok

    def cols_table(self, device) -> torch.Tensor:
        """``cols`` as an int32 tensor on ``device`` (cached)."""
        key = torch.device(device)
        if key not in self._tables:
            self._tables[key] = torch.as_tensor(self.cols, device=key)
        return self._tables[key]

    @property
    def sel(self) -> StaticSelection:
        """The repack: slot (s, r) reads CSR position ``pos[s, r]``."""
        if self._sel is None:
            self._sel = StaticSelection(self.pos, self.nnz)
        return self._sel

    def pack_data(self, csr_data):
        """CSR-ordered data (nnz,) -> (w, n_pad) slot-major (0 in pads)."""
        return self.sel.apply(csr_data).reshape(self.w, self.n_pad)

    def matvec_packed(self, packed, x):
        """y = A·x on packed data (kernel K7)."""
        return band_spmv_packed(self.cols_table(x.device), packed, x,
                                self.n_rows)


_BAND_PLAN_CACHE: dict = {}


def band_plan_for(indptr, indices, n_rows, n_cols) -> BandPlan:
    key = pattern_key(indptr, indices, n_rows, n_cols)
    plan = _BAND_PLAN_CACHE.get(key)
    if plan is None:
        plan = BandPlan(indptr, indices, int(n_rows), int(n_cols))
        _BAND_PLAN_CACHE[key] = plan
    return plan


# ---------------------------------------------------------------------------
# K7 and its plain version
# ---------------------------------------------------------------------------

def band_spmv_plain(cols, data, x, n_rows):
    """The masked sum over slots, in slot order: pad slots (col −1) add
    nothing, whatever their data."""
    acc = torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    for s in range(cols.shape[0]):
        c = cols[s, :n_rows]
        valid = c >= 0
        prod = data[s, :n_rows] * x[c.clamp(min=0).long()]
        acc = acc + torch.where(valid, prod, torch.zeros_like(prod))
    return acc


def band_spmv_packed(cols, data, x, n_rows):
    """``y[r] = Σ_s data[s, r]·x[cols[s, r]]`` over the slots with
    ``cols[s, r] ≥ 0``, for ``cols`` int32 and ``data`` (w, n_pad), ``x``
    (n_cols,), r < ``n_rows``."""
    _backend.refuse_grad("K7 band_spmv", data, x, via="csr_spmv")
    if x.device.type == "cpu":
        return band_spmv_plain(cols, data, x, n_rows)
    dtype = _value_dtype(x)
    _check("x", x, dtype, x.device, 1)
    _check("data", data, dtype, x.device, 2)
    _check("cols", cols, torch.int32, x.device, 2)
    if data.shape != cols.shape:
        raise ValueError(f"data {tuple(data.shape)} and cols "
                         f"{tuple(cols.shape)} differ in shape")
    w, n_pad = cols.shape
    if not 0 <= n_rows <= n_pad:
        raise ValueError(f"n_rows = {n_rows} outside [0, {n_pad}]")
    _fits_int32("n_rows", n_rows)
    _fits_int32("n_cols", x.shape[0])
    y = torch.empty(n_rows, dtype=dtype, device=x.device)
    lib = _lib()
    rc = getattr(lib, f"band_spmv_{_SUFFIX[dtype]}")(
        _backend.ptr(cols), _backend.ptr(data), _backend.ptr(x),
        _backend.ptr(y), n_rows, x.shape[0], n_pad, w,
        _backend.stream_handle(x))
    _backend.check_launch(lib, rc, "band_spmv")
    _backend.count_launch("band_spmv")
    return y


def band_spmv(plan: BandPlan, csr_data, x):
    """y = A·x through the band tier: the repack, then K7."""
    return plan.matvec_packed(plan.pack_data(csr_data), x)


def band_spmv_staged(plan: BandPlan, csr_data):
    """Staged closure: the repack once, then one K7 launch per product."""
    packed = plan.pack_data(csr_data)

    def mv(x):
        return plan.matvec_packed(packed, x)
    return mv

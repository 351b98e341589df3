"""The host-factored, device-applied sparse LU (the port of
``ops/device_lu.py``).

The numeric (re)factorization stays on the host — sequential elimination
suits neither the TPU nor the card — and the triangular factors are applied
on the device:

* the native factor (``native.SpLuFactor``) exports L and U in pivot space
  (``csrc/sparsetools.cpp:sp_lu_factor_export``): strict-lower L̂ (unit
  diagonal), strict-upper Û, the diagonal, and the composed row and column
  permutations;
* the factor's PATTERN holds across numeric-only refactorizations (the
  pivot order is frozen), so a level schedule is built on the host once a
  pattern: rows grouped by dependency depth.  A wide level is an ELL
  stage; runs of thin levels collapse into one dense lower-triangular
  block, applied by blocked substitution with its 128×128 diagonal blocks
  inverted on the host;
* ``refresh(data)`` refactors and packs every stage's values into one
  host buffer in the device layout: one copy of J's data to the host, one
  host pass, one copy of the buffer to the device.  ``solve(state, b)``
  then runs on the device only.

Each ELL stage, and each dense stage's gather of its dependencies on
earlier stages, is one launch of K5 (``ops.spmv.gather_spmv``) on that
stage's CSR tables (its valid slots, ``indptr`` from the per-row counts);
the refresh writes the values straight into that order.  On the CPU the
same call takes K5's plain version, so the CPU runs the card's route.  K5
takes any row length, so the JAX package's TPU sub-row split (``S``,
``MAX_SLOTS``) does not apply.  The dense stages are ``torch.mv`` in the
working precision (matrix–vector products: TF32 never applies; the JAX
package's ``Precision.HIGHEST``).

Each sweep works in its own ordering, in which every stage's rows are one
contiguous segment: every update is a slice update.  Three gathers bridge
the orderings (b → L order, L → U order, U order → x).

A re-pivot (a degraded pivot on refactorization) changes the fill pattern;
the refresh sees it in the factorization counter and returns a state with
``ok`` False, on which the caller falls back (``sparse_lu_device``: the
exact host route; the preconditioner: the identity).  ``device_lu_for``
then rebuilds the cached plan from the data that forced it.  Schedules of
more than ``MAX_LEVELS`` stages or with an ELL padding over
``PAD_RATIO_CAP`` are refused at plan time (``supported`` False).

The JAX package builds a plan inside the first solve's trace, so its cache
keeps an array of that trace, and a second solve on the same pattern fails
there; the port has no trace, and its cache serves every later solve.
"""

from __future__ import annotations

import hashlib
import sys
import threading
import time
from typing import Optional

import numpy as np
import torch

from .. import _backend
from .spmv import gather_spmv, pattern_key

MAX_LEVELS = 768          # stages of both sweeps together
PAD_RATIO_CAP = 4.0       # ELL padding budget against nnz(L) + nnz(U)
# Levels of at most this many rows are absorbed into dense triangular
# blocks (runs of consecutive thin levels); wider levels stay ELL stages.
DENSE_TAIL_MAX_LEVEL_ROWS = 128
DENSE_TAIL_ROWS_CAP = 1024
# Dense stages are applied by blocked substitution with host-inverted
# SB x SB diagonal blocks.
DENSE_SUB_BLOCK = 128


def _levels_from_csc(colptr, rowidx, n, *, descending=False):
    """Dependency depth per row of a strict triangular factor stored CSC by
    pivot column.  Entry (r, k) means row r depends on slot k; columns in
    elimination order (ascending for L, descending for U) are topological,
    so each column's level is final when its dependents are updated."""
    lvl = np.zeros(n, np.int64)
    order = range(n - 1, -1, -1) if descending else range(n)
    for k in order:
        rows = rowidx[colptr[k]:colptr[k + 1]]
        if rows.size:
            np.maximum.at(lvl, rows, lvl[k] + 1)
    return lvl


def _ell_rows(rows, row_start, kk, ee, counts, nnz):
    """ELL-pad the (col, export index) lists of ``rows``: pad slots point
    at index ``nnz``, where a zero is appended to the value vector."""
    w = int(counts[rows].max()) if rows.size else 0
    M = len(rows)
    cols = np.zeros((M, w), np.int64)
    vmap = np.full((M, w), nnz, np.int64)
    for i, rv in enumerate(rows):
        a, b = row_start[rv], row_start[rv + 1]
        cols[i, :b - a] = kk[a:b]
        vmap[i, :b - a] = ee[a:b]
    return cols, vmap


def _stage_schedule(colptr, rowidx, n, lvl, *, width_buckets=False):
    """The level schedule as an ordered list of stages (the JAX package's,
    entry for entry).

    A wide level stays an ELL stage ``('ell', rows (M,), cols (M, w), vmap
    (M, w))``: ``cols`` indexes the evolving solution, ``vmap`` the
    export-order values.  Runs of thin consecutive levels collapse into one
    stage ``('dense', block)``: rows ordered by (depth, pivot), so their
    mutual couplings form one strictly-lower (T, T) block; dependencies on
    earlier stages ride an ELL-padded pre-gather (``pre_cols`` /
    ``pre_vmap``).  Depth-0 rows outside any block are in no stage.

    Returns ``(stages, pad_slots)``."""
    nnz = int(colptr[n])
    cols_of = np.repeat(np.arange(n, dtype=np.int64), np.diff(colptr))
    r = np.asarray(rowidx, np.int64)
    order = np.lexsort((cols_of, r))
    rr, kk, ee = r[order], cols_of[order], order
    counts = np.bincount(rr, minlength=n)
    row_start = np.concatenate([[0], np.cumsum(counts)])
    nlev = int(lvl.max()) + 1 if n else 1

    stages = []
    total = 0
    pending = []          # row arrays of thin levels awaiting a block
    pending_rows = 0

    def build_block(row_groups):
        rows_t = np.concatenate(row_groups)      # (lvl asc, pivot asc)
        T = len(rows_t)
        tpos = np.full(n, -1, np.int64)
        tpos[rows_t] = np.arange(T)
        in_blk = tpos >= 0
        sel = in_blk[rr]
        rr_t, kk_t, ee_t = rr[sel], kk[sel], ee[sel]
        dense_sel = in_blk[kk_t]
        dense_ij = (tpos[rr_t[dense_sel]], tpos[kk_t[dense_sel]])
        dense_k = ee_t[dense_sel]
        pre_r, pre_k, pre_e = (rr_t[~dense_sel], kk_t[~dense_sel],
                               ee_t[~dense_sel])
        pcounts = np.bincount(pre_r, minlength=n)
        wp = int(pcounts[rows_t].max()) if T else 0
        pre_cols = np.zeros((T, wp), np.int64)
        pre_vmap = np.full((T, wp), nnz, np.int64)
        porder = np.argsort(pre_r, kind="stable")
        pre_k, pre_e = pre_k[porder], pre_e[porder]
        pstart = np.concatenate([[0], np.cumsum(pcounts)])
        for i, rv in enumerate(rows_t):
            a, b = pstart[rv], pstart[rv + 1]
            pre_cols[i, :b - a] = pre_k[a:b]
            pre_vmap[i, :b - a] = pre_e[a:b]
        return {"rows": rows_t, "pre_cols": pre_cols,
                "pre_vmap": pre_vmap, "dense_ij": dense_ij,
                "dense_k": dense_k, "T": T}

    def flush():
        nonlocal pending, pending_rows, total
        if pending:
            blk = build_block(pending)
            stages.append(("dense", blk))
            total += blk["pre_cols"].size
            pending, pending_rows = [], 0

    def ell_width_buckets(rows):
        """Split a level's rows into width classes (max ≤ ~2× min in a
        bucket) when padding the whole level to its widest row would waste
        more than half its nonzeros."""
        w_r = counts[rows]
        nnz_lvl = max(int(w_r.sum()), 1)
        pad_one = rows.size * int(w_r.max()) - nnz_lvl
        if not width_buckets or pad_one <= 0.5 * nnz_lvl:
            return [rows]
        order_w = np.argsort(w_r, kind="stable")
        rows_s, w_s = rows[order_w], w_r[order_w]
        start = 0
        out = []
        while start < len(rows_s):
            w0 = max(int(w_s[start]), 1)
            end = int(np.searchsorted(w_s, max(2 * w0, w0 + 8),
                                      side="right"))
            end = max(end, start + 1)
            out.append(rows_s[start:end])
            start = end
        return out

    for ell in range(1, nlev):
        rows = np.flatnonzero(lvl == ell)
        if rows.size == 0:
            continue
        if rows.size > DENSE_TAIL_MAX_LEVEL_ROWS:
            flush()
            for bucket in ell_width_buckets(rows):
                cols, vmap = _ell_rows(bucket, row_start, kk, ee,
                                       counts, nnz)
                stages.append(("ell", bucket, cols, vmap))
                total += cols.size
        else:
            if pending_rows + rows.size > DENSE_TAIL_ROWS_CAP:
                flush()
            pending.append(rows)
            pending_rows += int(rows.size)
    flush()
    return stages, total


def _gather_tables(cols, vmap, nnz_flat):
    """A gather table as K5's CSR: ``indptr`` (int32, from the per-row
    counts of valid slots), ``indices`` (int32: the valid slots' columns)
    and ``take`` (int64: their export-order value indices), all host."""
    valid = vmap != nnz_flat
    counts = valid.sum(axis=1)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return {"indptr": indptr, "indices": cols[valid].astype(np.int32),
            "take": vmap[valid].astype(np.int64)}


class DeviceLU:
    """Host-factored, device-applied sparse LU (see the module docstring).

    ``sample_data`` fixes the pivot order at plan time; refactorizations
    reuse it (KLU-style).  ``supported`` is False when the sample
    factorization fails or the schedule is too deep or too padded.  A
    failed native build raises."""

    def __init__(self, indptr, indices, n, *, perm=None, sample_data=None,
                 dtype=torch.float32):
        from ..native import SpLuFactor, amd_ordering
        self.n = int(n)
        self.dtype = _backend.resolve_dtype(dtype)
        self.supported = False
        self.fac = None
        self.repivoted = False     # a refresh met a pivot-order change
        self._repivot_data = None  # the data that forced it (rebase seed)
        self._refresh_lock = threading.Lock()
        self._device_tables: dict = {}
        self.refresh_times: dict = {}
        if perm is None:
            # a fill-reducing ordering is not optional here: natural-order
            # fill also deepens the level schedule
            perm = amd_ordering(np.asarray(indptr, np.int32),
                                np.asarray(indices, np.int32), self.n)
        fac = SpLuFactor(indptr, indices, self.n, perm=perm)
        if sample_data is None:
            # deterministic pseudo-values with a dominant diagonal: the
            # threshold pivoting then prefers the diagonal, the most
            # refactorization-stable order for PDE Jacobians
            rng = np.random.default_rng(0)
            indptr_a = np.asarray(indptr, np.int64)
            indices_a = np.asarray(indices, np.int64)
            rows = np.repeat(np.arange(self.n), np.diff(indptr_a))
            sample_data = rng.uniform(0.5, 1.5, size=len(indices_a))
            sample_data = np.where(indices_a == rows,
                                   10.0 + sample_data, -sample_data)
        if fac.factorize(np.asarray(sample_data, np.float64)) != 0:
            return
        exp = fac.export_factor()
        if exp is None:
            return
        self.fac = fac
        self.epoch = exp["n_factor"]
        self.nnzL = len(exp["Lrow"])
        self.nnzU = len(exp["Urow"])
        lvlL = _levels_from_csc(exp["Lp"], exp["Lrow"], self.n)
        lvlU = _levels_from_csc(exp["Up"], exp["Urow"], self.n,
                                descending=True)
        self.Lstages, padL = _stage_schedule(exp["Lp"], exp["Lrow"],
                                             self.n, lvlL)
        self.Ustages, padU = _stage_schedule(exp["Up"], exp["Urow"],
                                             self.n, lvlU)
        if padL + padU > PAD_RATIO_CAP * max(self.nnzL + self.nnzU, 1):
            # width buckets bound the waste of uneven levels at about 2x,
            # at the price of more stages: the fallback, not the default
            self.Lstages, padL = _stage_schedule(
                exp["Lp"], exp["Lrow"], self.n, lvlL, width_buckets=True)
            self.Ustages, padU = _stage_schedule(
                exp["Up"], exp["Urow"], self.n, lvlU, width_buckets=True)
        if len(self.Lstages) + len(self.Ustages) > MAX_LEVELS:
            return
        if padL + padU > PAD_RATIO_CAP * max(self.nnzL + self.nnzU, 1):
            return
        self._in_perm_np = exp["in_perm"].astype(np.int64)
        out_inv = np.empty(self.n, np.int64)
        out_inv[exp["out_perm"]] = np.arange(self.n)
        self._out_inv_np = out_inv
        self._build_sweep_orders()
        self._plan_stage_gathers()
        self._plan_state_layout()
        self.supported = True

    # -- the plan -----------------------------------------------------------

    def _build_sweep_orders(self):
        """Per-sweep renumbering: [untouched depth-0 rows] then each
        stage's rows as one contiguous segment, in stage order.  Stage
        column tables are remapped into the sweep's ordering; each stage's
        segment offset is recorded for its slice update."""
        def order_for(stages):
            groups = [stage[1]["rows"] if stage[0] == "dense" else stage[1]
                      for stage in stages]
            staged = (np.concatenate(groups) if groups
                      else np.zeros(0, np.int64))
            untouched = np.setdiff1d(np.arange(self.n, dtype=np.int64),
                                     staged, assume_unique=False)
            perm = np.concatenate([untouched, staged])
            pos = np.empty(self.n, np.int64)
            pos[perm] = np.arange(self.n)
            offs = []
            off = len(untouched)
            for g in groups:
                offs.append(off)
                off += len(g)
            return perm, pos, offs

        self._permL, posL, self._offL = order_for(self.Lstages)
        self._permU, posU, self._offU = order_for(self.Ustages)

        def remap(stages, pos):
            out = []
            for stage in stages:
                if stage[0] == "ell":
                    _t, rows, cols, vmap = stage
                    out.append(("ell", rows, pos[cols], vmap))
                else:
                    stage[1]["pre_cols"] = pos[stage[1]["pre_cols"]]
                    out.append(stage)
            return out

        self.Lstages = remap(self.Lstages, posL)
        self.Ustages = remap(self.Ustages, posU)
        # composed gathers: b -> L order, L order -> U order, U order -> x
        self._in_take = self._in_perm_np[self._permL]
        self._lu_map = posL[self._permU]
        self._out_take = posU[self._out_inv_np]

    def _plan_stage_gathers(self):
        """K5's CSR tables for every gather: each ELL stage, and each dense
        stage's pre-gather."""
        def attach(stages, nnz_flat):
            out = []
            for stage in stages:
                if stage[0] == "ell":
                    _tag, rows, cols, vmap = stage
                    out.append(("ell", rows, cols, vmap,
                                _gather_tables(cols, vmap, nnz_flat)))
                else:
                    blk = stage[1]
                    blk["pre"] = _gather_tables(blk["pre_cols"],
                                                blk["pre_vmap"], nnz_flat)
                    out.append(stage)
            return out

        self.Lstages = attach(self.Lstages, self.nnzL)
        self.Ustages = attach(self.Ustages, self.nnzU)

    def _plan_state_layout(self):
        """Where each stage's values sit in the one state buffer: Ud (n)
        first, then per stage its K5 values, or its block M (Tp, Tp), the
        inverses Minv (Tp/SB, SB, SB) and its pre-gather values."""
        SB = DENSE_SUB_BLOCK
        at = self.n

        def take(size):
            nonlocal at
            out = (at, at + size)
            at += size
            return out

        def layout(stages):
            out = []
            for stage in stages:
                if stage[0] == "ell":
                    out.append(take(len(stage[4]["take"])))
                else:
                    blk = stage[1]
                    Tp = -(-max(blk["T"], 1) // SB) * SB
                    out.append((take(Tp * Tp), take(Tp * SB),
                                take(len(blk["pre"]["take"])), Tp))
            return out

        self._layoutL = layout(self.Lstages)
        self._layoutU = layout(self.Ustages)
        self.state_size = at

    def stage_summary(self) -> dict:
        """Stage counts of the plan (L + U, how many are ELL), nnz(L),
        nnz(U), the K5 launches of one solve and the state's size."""
        def count(stages, tag):
            return sum(1 for s in stages if s[0] == tag)

        def launches(s):         # _gather_dot launches K5 when both > 0
            rows, g = ((len(s[1]), s[4]) if s[0] == "ell"
                       else (s[1]["T"], s[1]["pre"]))
            return int(rows > 0 and len(g["indices"]) > 0)

        return {"L_stages": len(self.Lstages), "U_stages": len(self.Ustages),
                "ell_stages": count(self.Lstages, "ell")
                + count(self.Ustages, "ell"),
                "dense_stages": count(self.Lstages, "dense")
                + count(self.Ustages, "dense"),
                "nnzL": self.nnzL, "nnzU": self.nnzU,
                "k5_launches_per_solve": sum(
                    launches(s) for s in self.Lstages + self.Ustages),
                "state_values": self.state_size}

    def tables(self, device) -> dict:
        """The plan's index tables on ``device`` (once a device): each
        gather's ``indptr`` / ``indices`` (int32), and the three sweep
        gathers (int64)."""
        device = torch.device(device)
        if device not in self._device_tables:
            def dev(a):
                return torch.as_tensor(a, device=device)

            def gathers(stages):
                return [(dev(g["indptr"]), dev(g["indices"]))
                        for g in (s[4] if s[0] == "ell" else s[1]["pre"]
                                  for s in stages)]

            self._device_tables[device] = {
                "L": gathers(self.Lstages), "U": gathers(self.Ustages),
                "in_take": dev(self._in_take), "lu_map": dev(self._lu_map),
                "out_take": dev(self._out_take)}
        return self._device_tables[device]

    # -- the refresh --------------------------------------------------------

    @staticmethod
    def _dense_block(blk, vals, diag, M, Minv):
        """Fill the dense stage's full lower-triangular block ``M`` (Tp,
        Tp) — unit diagonal when ``diag`` is None, padded rows the
        identity — and the inverses of its SB x SB diagonal blocks
        ``Minv`` (K, SB, SB), inverted on the host at refresh so that the
        device sweep is products only."""
        import scipy.linalg as sla
        T = blk["T"]
        SB = DENSE_SUB_BLOCK
        Tp = M.shape[0]
        M[:] = 0.0
        M[blk["dense_ij"]] = vals[blk["dense_k"]]
        dvec = np.ones(Tp)
        if diag is not None:
            dvec[:T] = diag[blk["rows"]]
        M[np.arange(Tp), np.arange(Tp)] = dvec
        eye = np.eye(SB)
        for k in range(Tp // SB):
            Mkk = M[k * SB:(k + 1) * SB, k * SB:(k + 1) * SB]
            Minv[k] = sla.solve_triangular(Mkk, eye, lower=True)

    def _pack(self, buf, stages, layout, vals, diag):
        SB = DENSE_SUB_BLOCK
        for stage, lay in zip(stages, layout):
            if stage[0] == "ell":
                lo, hi = lay
                buf[lo:hi] = vals[stage[4]["take"]]
            else:
                (m0, m1), (i0, i1), (p0, p1), Tp = lay
                self._dense_block(stage[1], vals, diag,
                                  buf[m0:m1].reshape(Tp, Tp),
                                  buf[i0:i1].reshape(Tp // SB, SB, SB))
                buf[p0:p1] = vals[stage[1]["pre"]["take"]]

    def _refresh_np(self, data) -> Optional[np.ndarray]:
        """Refactor with ``data`` (f64, host) and pack the state buffer in
        the plan's dtype; ``None`` when the factorization fails or
        re-pivots."""
        t0 = time.perf_counter()
        # one lock around factorize + export: no other refresh may put its
        # values between the two
        with self._refresh_lock:
            rc = self.fac.factorize(np.asarray(data, np.float64))
            exp = self.fac.export_factor() if rc == 0 else None
        t1 = time.perf_counter()
        self.refresh_times["factor_s"] = t1 - t0
        if exp is not None and exp["n_factor"] != self.epoch:
            # the re-pivot changed the fill pattern: the schedule no longer
            # applies.  Record the data so that device_lu_for rebases the
            # cached plan on it, and say so once.
            if not self.repivoted:
                self.repivoted = True
                self._repivot_data = np.asarray(data, np.float64).copy()
                print("[nonlinearsolve_tpu_torch:linear:precond_unavailable]"
                      " device_lu re-pivoted: the static schedule no longer "
                      "matches the factor; this plan's re-pivoted steps "
                      "fall back (device_lu_for rebases the cached plan on "
                      "its next call)", file=sys.stderr)
            exp = None
        if exp is None:
            return None
        buf = np.empty(self.state_size, np.float64)
        buf[:self.n] = exp["Ud"][self._permU]          # U-sweep order
        self._pack(buf, self.Lstages, self._layoutL, exp["Lval"], None)
        self._pack(buf, self.Ustages, self._layoutU, exp["Uval"], exp["Ud"])
        out = buf.astype(_backend.np_dtype(self.dtype), copy=False)
        self.refresh_times["pack_s"] = time.perf_counter() - t1
        return out

    def _views(self, buf, ok):
        """The state ``(Ud, L values, U values, ok)`` as views of the one
        device buffer."""
        SB = DENSE_SUB_BLOCK

        def views(stages, layout):
            out = []
            for stage, lay in zip(stages, layout):
                if stage[0] == "ell":
                    out.append(buf[lay[0]:lay[1]])
                else:
                    (m0, m1), (i0, i1), (p0, p1), Tp = lay
                    out.append((buf[m0:m1].view(Tp, Tp),
                                buf[i0:i1].view(Tp // SB, SB, SB),
                                buf[p0:p1]))
            return out

        return (buf[:self.n], views(self.Lstages, self._layoutL),
                views(self.Ustages, self._layoutU), ok)

    def refresh_host(self, data, device=None):
        """Refactor with host (or tensor) ``data`` and stage the state on
        ``device`` (the card when None) in one copy.  Returns the state
        for :meth:`solve`; its last entry ``ok`` is a host bool, False
        after a failed factorization or a re-pivot."""
        if isinstance(data, torch.Tensor):
            return self.refresh(data)
        return self._stage(np.asarray(data, np.float64),
                           _backend.resolve_device(device))

    def refresh(self, data: torch.Tensor):
        """Refactor with J's data (a tensor): one copy to the host, one host
        pass, one copy of the packed state to the data's device."""
        t0 = time.perf_counter()
        host = _backend.to_host(data.double())
        self.refresh_times["to_host_s"] = time.perf_counter() - t0
        return self._stage(host, data.device)

    def _stage(self, host, device):
        buf = self._refresh_np(host)
        if buf is None:
            return (None, None, None, False)
        t0 = time.perf_counter()
        dev_buf = torch.from_numpy(buf).to(device)
        self.refresh_times["to_device_s"] = time.perf_counter() - t0
        return self._views(dev_buf, True)

    # -- the solve ----------------------------------------------------------

    @staticmethod
    def _gather_dot(vals, tables, vec, m):
        """Σⱼ vals[i, j] · vec[cols[i, j]] for each of a stage's m rows: one
        K5 launch on the stage's CSR (its plain version on the CPU)."""
        indptr, indices = tables
        if m == 0 or indices.shape[0] == 0:
            return torch.zeros(m, dtype=vec.dtype, device=vec.device)
        return gather_spmv(indptr, indices, vals, vec)

    @staticmethod
    def _dense_solve(M, Minv, rhs):
        """Blocked forward substitution with the inverted diagonal blocks:
        xₖ = Minvₖ (rhsₖ − M[k, <k] x₍<k₎).  rhs (T,), T ≤ Tp; returns
        (T,)."""
        SB = DENSE_SUB_BLOCK
        Tp = M.shape[0]
        T = rhs.shape[0]
        rhs_p = torch.zeros(Tp, dtype=rhs.dtype, device=rhs.device)
        rhs_p[:T] = rhs
        x = torch.zeros_like(rhs_p)
        for k in range(Tp // SB):
            lo = k * SB
            acc = rhs_p[lo:lo + SB]
            if lo:
                acc = acc - torch.mv(M[lo:lo + SB, :lo], x[:lo])
            x[lo:lo + SB] = torch.mv(Minv[k], acc)
        return x[:T]

    def solve(self, state, b):
        """``x = A⁻¹ b`` on b's device with the state of a refresh: K5 on
        the ELL stages and pre-gathers, blocked substitution on the dense
        stages, each sweep in its own contiguous-segment order.  Returns
        ``(x, ok)``; with ``ok`` False (a re-pivot) x is b unchanged."""
        Ud, Lst, Ust, ok = state
        if not ok:
            return b, False
        _backend.count_route("device_lu")
        tab = self.tables(b.device)
        y = b[tab["in_take"]].to(Ud.dtype)              # L-sweep order
        for stage, sv, off, g in zip(self.Lstages, Lst, self._offL,
                                     tab["L"]):
            if stage[0] == "ell":
                m = len(stage[1])
                y[off:off + m] -= self._gather_dot(sv, g, y, m)
            else:
                M, Minv, pre = sv
                T = stage[1]["T"]
                rhs = y[off:off + T] - self._gather_dot(pre, g, y, T)
                y[off:off + T] = self._dense_solve(M, Minv, rhs)
        yu = y[tab["lu_map"]]                            # U-sweep order
        z = yu / Ud
        for stage, sv, off, g in zip(self.Ustages, Ust, self._offU,
                                     tab["U"]):
            if stage[0] == "ell":
                m = len(stage[1])
                g_dot = self._gather_dot(sv, g, z, m)
                z[off:off + m] = (yu[off:off + m] - g_dot) / Ud[off:off + m]
            else:
                M, Minv, pre = sv
                T = stage[1]["T"]
                rhs = yu[off:off + T] - self._gather_dot(pre, g, z, T)
                z[off:off + T] = self._dense_solve(M, Minv, rhs)
        return z[tab["out_take"]].to(b.dtype), True


_DEVICE_LU_CACHE: dict = {}


def device_lu_for(indptr, indices, n, **kw) -> Optional[DeviceLU]:
    """Pattern-keyed cache of DeviceLU plans (the host symbolic work runs
    once a pattern); ``None`` when the plan is unsupported.  The key holds
    the dtype (an f32 and an f64 solve on one pattern must not share the
    sweeps' precision) and a fingerprint of any explicit ``perm``.  A plan
    whose refresh met a re-pivot is rebuilt, seeded with the data that
    forced it, so that its pivot order matches the refactorizations."""
    dt = _backend.resolve_dtype(kw.get("dtype", torch.float32))
    kw = {**kw, "dtype": dt}
    perm = kw.get("perm")
    perm_fp = -1 if perm is None else hashlib.sha1(np.ascontiguousarray(
        np.asarray(perm, np.int64))).hexdigest()
    key = pattern_key(indptr, indices, n) + (str(dt), perm_fp)
    hit = _DEVICE_LU_CACHE.get(key, False)
    if hit is not False:
        if hit is None or not hit.repivoted:
            return hit
        kw = {**kw, "sample_data": hit._repivot_data}
    lu = DeviceLU(indptr, indices, n, **kw)
    out = lu if lu.supported else None
    _DEVICE_LU_CACHE[key] = out
    return out


def device_lu_preconditioner(csr):
    """The exact LU as a Krylov preconditioner: one refresh here, then
    ``apply(x) -> M⁻¹ x`` on the device (the role ILU / AMG play for the
    reference's Krylov path, with an exact factor).  ``None`` when no plan
    applies; after a re-pivot, ``apply`` is the identity."""
    lu = device_lu_for(np.asarray(csr.indptr), np.asarray(csr.indices),
                       csr.shape[0], dtype=csr.data.dtype)
    if lu is None:
        return None
    state = lu.refresh(csr.data)

    def apply(x):
        return lu.solve(state, x)[0]

    return apply

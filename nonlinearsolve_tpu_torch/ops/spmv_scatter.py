"""The expand/regroup SpMV tier, kernel K8 (the port of
``ops/pallas_spmv_scatter.py``).

For patterns without structure the JAX package factors the product:

    y = A x  =  R · (G ∘ data) x

``G`` (P × n_cols) has one nonzero a row, A's nonzeros in a host-chosen
order σ (zone-major, column-minor: ``σ = lexsort(row // B, col)``), so
``p = G x`` is the vector of products data·x[col]; ``R`` (n_rows × P, unit
data) sums each row's products.  Rows with more than 32 nonzeros chain R
(R₂·R₁), and patterns beyond the TPU's x envelope split into column-range
parts, each its own two-pass plan on x[c0:c1], whose outputs are summed.
``ScatterPlan`` keeps the JAX plan as it is (the parts, the three zone
heights tried per part, the G plan, the chained R plans and their costs),
so the port's tier and y are the JAX package's.  Per part the port keeps

- ``gcol``: (P,) int32, the G column of each position, −1 in zone pads;
- each R plan as an int32 CSR (``indptr``, positions);
- ``zstart``: each zone's first G position, and the part's CSR ``indptr``
  over A's rows (K8's tables, ``PartTables``);
- ``gsrc``: the CSR position of each G position (``nnz`` in pads), which
  ``stage`` applies once per Jacobian, for all parts in one launch of K5's
  selection.

K8 (``csrc/spmv.cu``) replaces ``ops/pallas_spmv_scatter.py``
``ScatterPlan.apply_staged`` (``scatter_spmv_pallas`` /
``scatter_spmv_staged``), two passes of the TPU's ELL kernel a part.  The
port fuses them: ``scatter_spmv_part`` is one launch a part, a block per
zone, which forms the zone's products in shared memory and sums each row
from there, so p never goes to device memory.  Part 0 writes y, each
later part adds to it.  The products are rounded one by one and each row
summed in the R chain's association with no FMA, so y is bit-equal to
the two passes (``scatter_part_plain``, the CPU path:
``scatter_expand_plain`` then ``scatter_regroup_plain``) and to
``scatter_part_sequential``, the reference the card is held to.  The
JAX package's custom VJP is ``ops/spmv.py``'s ``SpmvFunction`` on the
"scatter" route (K8 on Aᵀ's scatter plan); ``stage_unit`` is not ported
(the port's ``StaticSelection`` stays on ``gather_select``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _backend
from . import spmv as _ps
from .selection import StaticSelection
from .spmv import (LANES, MAX_SLOTS, MAX_WINDOW_ROWS, ROWS_PER_TILE, _SUFFIX,
                   EllPlan, _check, _fits_int32, _lib, _round_up,
                   _value_dtype, pattern_key)


def _x_cap() -> int:
    # read at call time: the envelope the EllPlan check consults is the one
    # the column splitter uses, under a test's monkeypatch too
    return _ps.MAX_X_ELEMS_VMEM


_W_ELEM_CAP = MAX_WINDOW_ROWS * LANES
_ZONE_ELEM_CAP = (3 * _W_ELEM_CAP) // 4


def _rt_for(w: int, n_rows: int) -> int:
    """The JAX plan's row-tiles per grid step (it sets the plans' n_pad)."""
    rt = max(1, 16 // max(w, 1))
    while rt > 1 and (rt * ROWS_PER_TILE) > 2 * max(n_rows, 1):
        rt //= 2
    return rt


def _ell_cost(plan: EllPlan, *, effective=False) -> float:
    if effective:
        return _ps._derated_cost("resident", plan)
    return _ps.spmv_tier_cost("resident", plan)


class _TwoPassPart:
    """One column-range part: G (expand, A's data) and the chained R
    reductions.  When ``ok``: ``g_plan`` and ``r_plans`` (EllPlans), ``sigma``
    (part-CSR order -> G-row order), ``P``, ``B``, ``cost``, ``table_bytes``,
    and the port's ``gcol``, ``r_tables`` and ``pos_sorted`` (the G
    position of each nonzero in σ order)."""

    def __init__(self, indptr, indices, n_rows, n_cols):
        self.ok = False
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        counts = np.diff(indptr)
        nnz = len(indices)
        if nnz == 0 or n_rows == 0:
            return
        w = int(counts.max())
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)

        # candidate zone heights around the G/R balance point
        b_opt = int(np.sqrt(128.0 * max(n_cols, 1)) / max(w, 1))
        cand = []
        for b in (b_opt // 2, b_opt, 2 * b_opt):
            b = max(128 * max(b // 128, 1), 128)
            while b > 128 and b * w > _ZONE_ELEM_CAP:
                b //= 2
            if b not in cand:
                cand.append(b)
        best = None
        for B in cand:
            built = self._try_build(indptr, indices, rows, n_rows, n_cols,
                                    nnz, B)
            if built is None:
                continue
            if best is None or built["eff_cost"] < best["eff_cost"]:
                best = built
        if best is None:
            return
        for k in ("g_plan", "r_plans", "sigma", "P", "B", "cost",
                  "table_bytes", "gcol", "pos_sorted", "r_tables",
                  "zstart"):
            setattr(self, k, best[k])
        self.indptr = np.asarray(indptr, np.int32)
        self.n_rows = n_rows
        self.n_cols = n_cols
        self.nnz = nnz
        self.ok = True

    @staticmethod
    def _try_build(indptr, indices, rows, n_rows, n_cols, nnz, B):
        blk = rows // B
        nblocks = int(blk[-1]) + 1 if nnz else 1
        # lexsort((indices, blk)) as one stable sort of a combined key
        order = np.argsort(blk * max(n_cols, 1) + indices, kind="stable")
        zs = np.bincount(blk, minlength=nblocks)        # zone nnz
        zpad = ((zs + 127) // 128) * 128
        zstart = np.concatenate([[0], np.cumsum(zpad)])[:-1]
        zcum = np.concatenate([[0], np.cumsum(zs)])
        sorted_blk = blk[order]
        rank = np.arange(nnz, dtype=np.int64) - zcum[sorted_blk]
        pos_sorted = zstart[sorted_blk] + rank
        P = int(zpad.sum())
        if P > _x_cap():
            return None

        # G: P rows, one column each at the padded position's nonzero
        g_counts = np.zeros(P, np.int64)
        g_counts[pos_sorted] = 1
        g_indptr = np.concatenate([[0], np.cumsum(g_counts)])
        g_indices = indices[order]
        g_plan = EllPlan(g_indptr, g_indices, P, n_cols, rt=_rt_for(1, P))
        if not g_plan.supported:
            return None

        # R chain: each row's product positions, ascending
        pos_csr = np.empty(nnz, np.int64)
        pos_csr[order] = pos_sorted
        cur_indptr, cur_indices = indptr, pos_csr
        cur_len, out_rows = P, n_rows
        r_plans, r_tables = [], []
        while True:
            ccounts = np.diff(cur_indptr)
            wmax = int(ccounts.max()) if ccounts.size else 1
            if wmax <= MAX_SLOTS:
                rp = EllPlan(cur_indptr, cur_indices, out_rows, cur_len,
                             rt=_rt_for(wmax, out_rows))
                if not rp.supported:
                    return None
                r_plans.append(rp)
                r_tables.append((cur_indptr, cur_indices))
                break
            # split every row's entries into <= MAX_SLOTS chunks: R1 sums
            # the chunks into sub-rows, the next R folds the sub-rows
            nsub = (ccounts + MAX_SLOTS - 1) // MAX_SLOTS
            nsub = np.maximum(nsub, 1)
            sub_total = int(nsub.sum())
            sub_row = np.repeat(np.arange(len(ccounts)), nsub)
            sub_first = np.concatenate([[0], np.cumsum(nsub)])[:-1]
            sub_rank = np.arange(sub_total) - sub_first[sub_row]
            sub_counts = np.minimum(
                ccounts[sub_row] - sub_rank * MAX_SLOTS, MAX_SLOTS)
            r1_indptr = np.concatenate([[0], np.cumsum(sub_counts)])
            rp1 = EllPlan(r1_indptr, cur_indices, sub_total, cur_len,
                          rt=_rt_for(MAX_SLOTS, sub_total))
            if not rp1.supported:
                return None
            r_plans.append(rp1)
            r_tables.append((r1_indptr, cur_indices))
            cur_indptr = np.concatenate([[0], np.cumsum(nsub)])
            cur_indices = np.arange(sub_total, dtype=np.int64)
            cur_len = sub_total

        cost = _ell_cost(g_plan) * (g_plan.n_pad // LANES)
        eff = _ell_cost(g_plan, effective=True) * (g_plan.n_pad // LANES)
        table_bytes = 8 * g_plan.table_size + 8 * P
        for rp in r_plans:
            cost += _ell_cost(rp) * (rp.n_pad // LANES)
            eff += _ell_cost(rp, effective=True) * (rp.n_pad // LANES)
            table_bytes += 8 * rp.table_size
        gcol = np.full(P, -1, np.int32)
        gcol[pos_sorted] = g_indices
        # every row's zone, the ones past the last nonzero's empty
        zones = np.full(-(-n_rows // B) + 1, P, np.int64)
        zones[:nblocks] = zstart
        return {"g_plan": g_plan, "r_plans": r_plans, "sigma": order,
                "P": P, "B": B, "cost": cost, "eff_cost": eff,
                "table_bytes": table_bytes, "gcol": gcol,
                "pos_sorted": pos_sorted, "zstart": zones.astype(np.int32),
                "r_tables": [(np.asarray(ip, np.int32),
                              np.asarray(ix, np.int32))
                             for ip, ix in r_tables]}


class ScatterPlan:
    """The JAX package's two-pass plan for one pattern, with column-range
    parts when n_cols or the product vector exceed its x envelope.
    ``parts`` is a list of (c0, c1, sel, _TwoPassPart): the column range
    and ``sel``, A's CSR positions of the part's nonzeros."""

    def __init__(self, indptr, indices, n_rows, n_cols):
        self.ok = False
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        self.n_rows = int(n_rows)
        self.n_cols = int(n_cols)
        self.n_pad = _round_up(max(self.n_rows, 1), ROWS_PER_TILE)
        nnz = len(indices)
        if nnz == 0:
            return
        cap = int(0.9 * _x_cap())
        nsplit = max(-(-self.n_cols // cap), -(-nnz // cap))
        # column boundaries balancing nnz per part
        if nsplit == 1:
            bounds = [0, self.n_cols]
        else:
            percol = np.bincount(indices, minlength=self.n_cols)
            cums = np.cumsum(percol)
            targets = (np.arange(1, nsplit) * nnz) / nsplit
            cuts = np.searchsorted(cums, targets) + 1
            bounds = [0] + sorted(set(int(c) for c in cuts)) + [self.n_cols]
            bounds = sorted(set(bounds))
        counts = np.diff(indptr)
        rows = np.repeat(np.arange(self.n_rows, dtype=np.int64), counts)
        parts = []
        for c0, c1 in zip(bounds[:-1], bounds[1:]):
            sel = np.flatnonzero((indices >= c0) & (indices < c1))
            if sel.size == 0:
                continue
            if sel.size > _x_cap():
                return      # a single column range can't be split further
            prows = rows[sel]
            pindices = indices[sel] - c0
            pindptr = np.concatenate(
                [[0], np.cumsum(np.bincount(prows,
                                            minlength=self.n_rows))])
            part = _TwoPassPart(pindptr, pindices, self.n_rows, c1 - c0)
            if not part.ok:
                return
            parts.append((int(c0), int(c1), sel, part))
        if not parts:
            return
        self.parts = parts
        self.nnz = nnz
        self.cost = sum(p.cost for (_c0, _c1, _s, p) in parts)
        self.table_bytes = sum(p.table_bytes
                               for (_c0, _c1, _s, p) in parts)
        # the staging selection: G position -> A's CSR position, all parts
        # end to end
        gsrc = []
        for (_c0, _c1, sel, part) in parts:
            src = np.full(part.P, nnz, np.int64)
            src[part.pos_sorted] = sel[part.sigma]
            gsrc.append(src)
        self._gsrc = np.concatenate(gsrc)
        self._sel = None
        self._tables: dict = {}
        self.ok = True

    @property
    def supported(self) -> bool:
        return self.ok

    @property
    def sel(self) -> StaticSelection:
        if self._sel is None:
            self._sel = StaticSelection(self._gsrc, self.nnz)
        return self._sel

    def tables(self, device) -> list:
        """Per part, its ``PartTables`` on ``device`` (cached)."""
        key = torch.device(device)
        if key not in self._tables:
            def dev(a):
                return torch.as_tensor(a, device=key)
            self._tables[key] = [
                PartTables(c0, c1, dev(part.gcol),
                           [(dev(ip), dev(ix)) for ip, ix in part.r_tables],
                           tuple(int(np.diff(ip).max())
                                 for ip, _ix in part.r_tables),
                           dev(part.zstart), dev(part.indptr), part.B,
                           int(np.diff(part.zstart).max()))
                for (c0, c1, _sel, part) in self.parts]
        return self._tables[key]

    def stage(self, csr_data) -> list:
        """Per part, its G data (P,): A's data at each G position, 0 in
        zone pads (one selection launch for all parts, once per
        Jacobian)."""
        gdata = self.sel.apply(csr_data)
        out, at = [], 0
        for (_c0, _c1, _sel, part) in self.parts:
            out.append(gdata[at:at + part.P])
            at += part.P
        return out

    def apply_staged(self, staged, x):
        """y = Σ_parts R·((G∘data)·x[c0:c1]) with the staged G data, the
        parts added in order (one K8 launch a part)."""
        _backend.refuse_grad("K8 scatter_spmv_part", x, *staged,
                             via="csr_spmv")
        parts = list(zip(self.tables(x.device), staged))
        if not parts or x.device.type == "cpu":
            y = None
            for t, gdata in parts:
                y = scatter_spmv_part(t, gdata, x, y)
            return y
        y = _check_part(*parts[0], x, None)
        for t, gdata in parts[1:]:
            _check_part(t, gdata, x, y)
        # back to back on the stream, nothing launched between them: each
        # part after the first may overlap the one before
        for i, (t, gdata) in enumerate(parts):
            _launch_part(t, gdata, x, y, accumulate=i > 0, overlap=i > 0)
        return y


class PartTables(NamedTuple):
    """One part's device tables.  ``gcol``: (P,) int32, the G column of
    each position, −1 in zone pads; ``r_tables``: the R chain, each an
    int32 CSR ``(indptr, pos)`` (the first one's ``pos``, the G position
    of each of the part's nonzeros in CSR order, is K8's ``pos``);
    ``r_widths``: each R level's longest row; ``zstart``: (n_zones + 1,)
    int32, the first G position of each zone of ``rows_per_zone`` rows (P
    for the zones past the last nonzero);
    ``rptr``: the part's CSR indptr over A's rows; ``max_zone``: the
    largest zone's positions."""
    c0: int
    c1: int
    gcol: torch.Tensor
    r_tables: list
    r_widths: tuple
    zstart: torch.Tensor
    rptr: torch.Tensor
    rows_per_zone: int
    max_zone: int

    @property
    def pos(self):
        return self.r_tables[0][1]


_SCATTER_PLAN_CACHE: dict = {}


def scatter_plan_for(indptr, indices, n_rows, n_cols) -> ScatterPlan:
    key = pattern_key(indptr, indices, n_rows, n_cols)
    plan = _SCATTER_PLAN_CACHE.get(key)
    if plan is None:
        plan = ScatterPlan(indptr, indices, int(n_rows), int(n_cols))
        _SCATTER_PLAN_CACHE[key] = plan
    return plan


# ---------------------------------------------------------------------------
# K8 and its plain versions
# ---------------------------------------------------------------------------

def scatter_expand_plain(gcol, gdata, x):
    """``index_select`` of x and the products; 0 where gcol is −1."""
    valid = gcol >= 0
    prod = gdata * x.index_select(0, gcol.clamp(min=0).long())
    return torch.where(valid, prod, torch.zeros_like(prod))


def scatter_regroup_plain(indptr, pos, p):
    """``index_add_`` of p at each row's positions (unit data)."""
    n_rows = indptr.shape[0] - 1
    k = torch.arange(pos.shape[0], dtype=indptr.dtype, device=p.device)
    rows = torch.searchsorted(indptr[1:], k, right=True)
    return torch.zeros(n_rows, dtype=p.dtype, device=p.device).index_add_(
        0, rows, p.index_select(0, pos.long()))


def slot_sum_plain(indptr, pos, p, width):
    """``y[r] = Σ p[pos[k]]`` over ``indptr[r] <= k < indptr[r+1]``, one
    slot at a time in R's order (a loop over the ``width`` slots of the
    longest row, vectorised across rows): a sum in the same order as
    ``scatter_regroup_plain`` on the CPU that is also deterministic on the
    card, where ``index_add_`` adds by atomics in no fixed order."""
    n_rows = indptr.shape[0] - 1
    start = indptr[:-1].long()
    counts = indptr[1:].long() - start
    acc = torch.zeros(n_rows, dtype=p.dtype, device=p.device)
    pad = p.shape[0]
    p_ext = torch.cat([p, p.new_zeros(1)])
    last = max(pos.shape[0] - 1, 0)
    # a pad slot adds +0, which leaves a sum begun at +0 as it is
    for s in range(width):
        k = torch.where(counts > s, pos.long()[(start + s).clamp(max=last)],
                        pad)
        acc = acc + p_ext[k]
    return acc


def scatter_part_plain(t: PartTables, gdata, x, y=None):
    """K8's plain version, the two passes: ``scatter_expand_plain``, the R
    chain by ``scatter_regroup_plain``, then ``y + p``."""
    p = scatter_expand_plain(t.gcol, gdata, x[t.c0:t.c1])
    for indptr, pos in t.r_tables:
        p = scatter_regroup_plain(indptr, pos, p)
    return p if y is None else y + p


def scatter_part_sequential(t: PartTables, gdata, x, y=None):
    """The sequential reference of one part: ``scatter_expand_plain``'s
    products, each R level of the chain summed by ``slot_sum_plain``, then
    ``y + p``.  K8 equals it bit for bit, on the card and off it."""
    p = scatter_expand_plain(t.gcol, gdata, x[t.c0:t.c1])
    for (indptr, pos), width in zip(t.r_tables, t.r_widths):
        p = slot_sum_plain(indptr, pos, p, width)
    return p if y is None else y + p


def scatter_spmv_part(t: PartTables, gdata, x, y=None):
    """One column part of the product: ``R·((G∘gdata)·x[c0:c1])``, or,
    when ``y`` is given, that added to ``y`` in place (and ``y``
    returned).  ``gdata`` (P,) is the part's staged G data, ``x``
    (n_cols,) the whole vector.  The products are rounded one by one and
    each row summed in the R chain's association, with no FMA:
    ``scatter_part_sequential``'s bits."""
    _backend.refuse_grad("K8 scatter_spmv_part", gdata, x, y,
                        via="csr_spmv")
    if x.device.type == "cpu":
        p = scatter_part_plain(t, gdata, x)
        return p if y is None else y.add_(p)
    out = _check_part(t, gdata, x, y)
    _launch_part(t, gdata, x, out, accumulate=y is not None, overlap=False)
    return out


def _check_part(t: PartTables, gdata, x, y):
    """Refuses what K8 does not take; returns the output, ``y`` or a new
    vector."""
    dtype = _value_dtype(x)
    dev = x.device
    _check("x", x, dtype, dev, 1)
    _check("gdata", gdata, dtype, dev, 1)
    for name in ("gcol", "zstart", "rptr", "pos"):
        _check(name, getattr(t, name), torch.int32, dev, 1)
    if t.gcol.shape != gdata.shape:
        raise ValueError("gcol and gdata differ in length")
    if not 0 <= t.c0 <= t.c1 <= x.shape[0]:
        raise ValueError(f"columns [{t.c0}, {t.c1}) outside x of length "
                         f"{x.shape[0]}")
    n_rows = t.rptr.shape[0] - 1
    n_zones = t.zstart.shape[0] - 1
    if n_zones * t.rows_per_zone < n_rows:
        raise ValueError(f"{n_zones} zones of {t.rows_per_zone} rows do not "
                         f"cover {n_rows} rows")
    _fits_int32("P", t.gcol.shape[0])
    _fits_int32("nnz", t.pos.shape[0])
    _fits_int32("n_rows", n_rows)
    if y is None:
        return torch.empty(n_rows, dtype=dtype, device=dev)
    _check("y", y, dtype, dev, 1)
    if y.shape[0] != n_rows:
        raise ValueError(f"y has {y.shape[0]} rows, expected {n_rows}")
    return y


def _launch_part(t: PartTables, gdata, x, y, *, accumulate, overlap):
    """K8 on one part of checked tables: writes ``y``, or adds to it when
    ``accumulate``.  ``overlap`` only where the last launch on the stream
    was the previous part of the same product, which writes none of this
    part's inputs but ``y``: the launch then forms its products while that
    one ends (a programmatic dependent launch) and waits for it before it
    reads ``y``."""
    lib = _lib()
    rc = getattr(lib, f"scatter_part_{_SUFFIX[y.dtype]}")(
        _backend.ptr(t.gcol), _backend.ptr(gdata),
        _backend.ptr(x[t.c0:t.c1]), _backend.ptr(t.zstart),
        _backend.ptr(t.rptr), _backend.ptr(t.pos), _backend.ptr(y),
        t.zstart.shape[0] - 1, y.shape[0], t.c1 - t.c0, t.rows_per_zone,
        t.max_zone, int(accumulate), int(overlap), _backend.stream_handle(x))
    _backend.check_launch(lib, rc, "scatter_spmv_part")
    _backend.count_launch("scatter_spmv_part")


def scatter_spmv(plan: ScatterPlan, csr_data, x):
    """y = A·x through the two-pass tier (staging, then K8 a part)."""
    return plan.apply_staged(plan.stage(csr_data), x)


def scatter_spmv_staged(plan: ScatterPlan, csr_data):
    """Staged closure: the G data once, then K8 a part per product."""
    staged = plan.stage(csr_data)

    def mv(x):
        return plan.apply_staged(staged, x)
    return mv

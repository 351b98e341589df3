"""Row-partitioned general-sparse SpMV over a device mesh (the port of
``parallel/sparse_dist.py``).

A square CSR operator is row-partitioned over one axis of a ``DeviceMesh``:
rank s of the axis owns rows [s·chunk, (s+1)·chunk) with chunk = ⌈n/S⌉, and
applies them to an x buffer that holds its own chunk of x and the off-shard
columns its rows read.  Those arrive by a ring halo exchange on
``torch.distributed.batch_isend_irecv`` (up to ``_MAX_HALO_HOPS`` neighbour
chunks a side, the farthest hop sliced) when every shard's column window
fits, and by one ``all_gather`` of x otherwise (scrambled patterns).  The
exchange is issued before the shard's data is read.

``build_sharded_csr_plan`` is the JAX package's plan, field for field where
the port keeps the field: the row partition, the halo widths, the mode and
``buf_len``; the per-shard ``EllPlan`` probe forced to one slot count,
window height and granularity, which gives ``w``, ``W``, ``kmode``,
``ntiles``, ``nx_rows`` and ``pallas_ok`` (the TPU kernel's envelope); and
the segment-sum tables ``seg_pos``, ``seg_row``, ``seg_src``,
``seg_valid``.  The TPU tile tables (``r0_all``, ``idx_all``,
``perm_all``, ``valid_all``) are not built: K5 reads CSR, so each shard
keeps its local CSR instead — its rebased row pointers
(``shard_indptr``), its columns remapped into the x buffer (the first
``shard_indptr[s, -1]`` entries of ``seg_pos[s]``) and its data's source
offsets (``seg_src[s]``, a contiguous run of the global data).

``make_sharded_csr_matvec``'s tiers keep the JAX names: "pallas" is K5
(``ops.spmv.gather_spmv``) on each shard's tables — the kernel on a CUDA
tensor, its plain version on a CPU one — and "segment_sum" is the products
and a plain ``index_add_`` by local row (the JAX package's XLA tier).  K5
takes any pattern, so the TPU envelope does not bind the "pallas" tier:
``use_pallas=True`` takes it whatever ``pallas_ok`` says, and the default
takes it on a CUDA mesh (the JAX default takes Pallas on the TPU when the
plans fit, and segment_sum off it).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import _backend
from ..ops import spmv
from .distributed import _issue_halo_exchange, _wait
from .mesh import mesh_device, row_sharding

#: halo widths up to this many neighbour chunks take ring hops; wider
#: windows take the all_gather path
_MAX_HALO_HOPS = 3


class ShardedCsrPlan(NamedTuple):
    """Host-built plan for one (pattern, n_shards) pair."""
    n: int                   # global square dimension
    n_shards: int
    chunk: int               # rows per shard (n padded to n_shards*chunk)
    mode: str                # "halo" | "allgather"
    hl: int                  # left halo width (cols), halo mode
    hr: int                  # right halo width
    buf_len: int             # per-shard x buffer length
    ntiles: int              # the JAX kernel's grid steps per shard
    w: int                   # common slot count
    W: Optional[int]         # common window height (x-tile rows)
    nx_rows: Optional[int]   # padded x-buffer tile rows
    kmode: Optional[str]     # window granularity: "slot" | "group"
    pallas_ok: bool          # every shard within the TPU kernel envelope
    shard_indptr: np.ndarray  # (S, chunk+1) int64 local row pointers
    seg_pos: np.ndarray      # (S, nnz_max) int32 buffer position
    seg_row: np.ndarray      # (S, nnz_max) int32 local row
    seg_src: np.ndarray      # (S, nnz_max) int64 global data idx
    seg_valid: np.ndarray    # (S, nnz_max) bool


_PLAN_CACHE: dict = {}


def build_sharded_csr_plan(indptr, indices, n, n_shards) -> ShardedCsrPlan:
    """Plan the row partition, the halo strategy and the per-shard
    layouts (host, cached by pattern; ``spmv.clear_plan_caches`` empties
    the cache).  ``W``, ``nx_rows`` and ``kmode`` are None when a shard is
    outside the envelope for its buffer length or slot count, where the
    JAX plan's window fields are not read (``pallas_ok`` is False)."""
    key = spmv.pattern_key(indptr, indices, n, n_shards)
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit

    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    S = int(n_shards)
    chunk = -(-n // S)

    # per-shard column windows → halo widths
    c0 = np.zeros(S, np.int64)
    c1 = np.zeros(S, np.int64)
    for s in range(S):
        r_lo, r_hi = s * chunk, min((s + 1) * chunk, n)
        cols = indices[indptr[r_lo]:indptr[r_hi]] if r_lo < n else indices[:0]
        if cols.size:
            c0[s], c1[s] = cols.min(), cols.max() + 1
        else:
            c0[s], c1[s] = s * chunk, s * chunk
    hl = int(max(0, (np.arange(S) * chunk - c0).max()))
    hr = int(max(0, (c1 - (np.arange(S) + 1) * chunk).max()))
    # widths up to _MAX_HALO_HOPS neighbour chunks ride the ring; wider
    # windows, or halos covering most of the ring anyway, take all_gather
    hops = max(-(-hl // chunk), -(-hr // chunk))
    if hops <= _MAX_HALO_HOPS and hl + hr < (S - 1) * chunk:
        mode = "halo"
    else:
        mode, hl, hr = "allgather", 0, 0
    buf_len = hl + chunk + hr if mode == "halo" else S * chunk

    # per-shard local patterns (columns remapped into the buffer)
    shard_patterns = []
    nnz_max = 1
    for s in range(S):
        r_lo, r_hi = s * chunk, min((s + 1) * chunk, n)
        base = indptr[r_lo] if r_lo < n else indptr[n]
        sub_indptr = np.zeros(chunk + 1, np.int64)
        if r_lo < n:
            sub_indptr[:r_hi - r_lo + 1] = indptr[r_lo:r_hi + 1] - base
            sub_indptr[r_hi - r_lo + 1:] = sub_indptr[r_hi - r_lo]
        cols = indices[base:indptr[r_hi]] if r_lo < n else indices[:0]
        shift = (s * chunk - hl) if mode == "halo" else 0
        shard_patterns.append((sub_indptr, cols - shift, int(base)))
        nnz_max = max(nnz_max, int(cols.size))

    # the JAX plan's two passes: learn each shard's (w, mode), then force
    # the common slot count and granularity and take the largest window
    probe = [spmv.EllPlan(sp, lc, chunk, buf_len)
             for sp, lc, _ in shard_patterns]
    w = max(p.w for p in probe)
    ntiles = probe[0].ntiles
    if any(p.mode is None for p in probe):
        W = nx_rows = kmode = None
        pallas_ok = False
    else:
        kmode = "slot" if all(p.mode == "slot" for p in probe) else "group"
        plans = [spmv.EllPlan(sp, lc, chunk, buf_len, min_w=w,
                              force_mode=kmode)
                 for sp, lc, _ in shard_patterns]
        W = max(p.W for p in plans)
        p0 = spmv.EllPlan(*shard_patterns[0][:2], chunk, buf_len, min_w=w,
                          min_W=W, force_mode=kmode)
        nx_rows = p0.nx_rows
        pallas_ok = (buf_len <= spmv.MAX_X_ELEMS_VMEM
                     and W <= spmv.MAX_WINDOW_ROWS and w <= spmv.MAX_SLOTS
                     and p0.r0_size * 4 <= spmv._SMEM_R0_CAP_BYTES)

    shard_indptr = np.stack([sp for sp, _, _ in shard_patterns])
    seg_pos = np.zeros((S, nnz_max), np.int32)
    seg_row = np.zeros((S, nnz_max), np.int32)
    seg_src = np.zeros((S, nnz_max), np.int64)
    seg_valid = np.zeros((S, nnz_max), bool)
    for s, (sub_indptr, local_cols, off) in enumerate(shard_patterns):
        m = local_cols.size
        seg_pos[s, :m] = local_cols
        seg_row[s, :m] = np.repeat(np.arange(chunk), np.diff(sub_indptr))
        seg_src[s, :m] = off + np.arange(m)
        seg_valid[s, :m] = True

    plan = ShardedCsrPlan(
        n=int(n), n_shards=S, chunk=chunk, mode=mode, hl=hl, hr=hr,
        buf_len=buf_len, ntiles=ntiles, w=w, W=W, nx_rows=nx_rows,
        kmode=kmode, pallas_ok=pallas_ok, shard_indptr=shard_indptr,
        seg_pos=seg_pos, seg_row=seg_row, seg_src=seg_src,
        seg_valid=seg_valid)
    _PLAN_CACHE[key] = plan
    return plan


def _ring_halo(group, x_local, hl: int, hr: int):
    """This shard's chunk with the ``hl`` entries that precede it and the
    ``hr`` that follow it on the periodic ring of ``group`` — several
    neighbour chunks deep where the widths need it (a width of 0 issues
    nothing)."""
    left, right, works = _issue_halo_exchange(group, x_local, hl, hr)
    _wait(works)
    return torch.cat([left, x_local, right])


def _all_gather(group, x_local):
    """The chunks of every rank of ``group``, in rank order: one
    ``all_gather`` (none on a one-rank group, where it is the identity)."""
    size = dist.get_world_size(group)
    if size == 1:
        return x_local
    parts = [torch.empty_like(x_local) for _ in range(size)]
    _backend.count_collective("all_gather")
    dist.all_gather(parts, x_local, group=group)
    return torch.cat(parts)


def make_sharded_csr_matvec(csr, mesh, axis: str = "x", *,
                            use_pallas: Optional[bool] = None) -> Callable:
    """``matvec(x, *, data=None) -> y`` for a square ``CSR`` operator,
    row-partitioned over ``mesh[axis]`` (a ``DeviceMesh``).

    ``x`` is a DTensor (redistributed to the row sharding if it has
    another) or a plain tensor, the same on every rank; ``y`` comes back a
    row-sharded DTensor of shape (n,).  Every rank of the mesh calls it.
    ``data`` replaces the operator's values on the same pattern (a plain
    tensor or a DTensor of the global data, in CSR order); the default
    data is sliced to this rank's shard once, here.  ``use_pallas``
    forces the K5 tier or the segment-sum tier (see the module's note).
    The callable carries ``plan``, ``tier`` and ``local``: the product on
    this rank's own x chunk, zero-padded to ``plan.chunk`` entries, which
    returns the chunk's rows of y (padded likewise) without DTensor's
    dispatch, for a caller that keeps its own shards."""
    n = csr.shape[0]
    if csr.shape[0] != csr.shape[1]:
        raise ValueError("row-sharded matvec requires a square operator")
    group = mesh.get_group(axis)
    S = dist.get_world_size(group)
    me = dist.get_rank(group)
    plan = build_sharded_csr_plan(csr.indptr, csr.indices, n, S)
    pallas = (mesh.device_type == "cuda" if use_pallas is None
              else bool(use_pallas))
    device = mesh_device(mesh)
    chunk = plan.chunk
    local_rows = max(0, min(chunk, n - me * chunk))
    nnz = int(plan.shard_indptr[me, -1])
    base = int(plan.seg_src[me, 0])
    placements = row_sharding(mesh, axis, 1)
    indptr = torch.as_tensor(plan.shard_indptr[me].astype(np.int32),
                             device=device)
    cols = torch.as_tensor(plan.seg_pos[me, :nnz], device=device)
    rows = torch.as_tensor(plan.seg_row[me, :nnz].astype(np.int64),
                           device=device)

    def shard_data(data):
        if isinstance(data, DTensor):
            data = data.full_tensor()
        return data[base:base + nnz].to(device).contiguous()

    default = shard_data(csr.data)

    def x_chunk(x):
        if isinstance(x, DTensor):
            if list(x.placements) != placements:
                x = x.redistribute(mesh, placements)
            xl = x.to_local()
        else:
            xl = x[me * chunk:me * chunk + local_rows]
        if xl.shape[0] < chunk:
            xl = torch.cat([xl, xl.new_zeros(chunk - xl.shape[0])])
        return xl.contiguous()

    def local(xl, data=None):
        if plan.mode == "halo":
            buf = _ring_halo(group, xl, plan.hl, plan.hr)
        else:
            buf = _all_gather(group, xl)
        vals = default if data is None else shard_data(data)
        if pallas:
            return spmv.gather_spmv(indptr, cols, vals, buf)
        return torch.zeros(chunk, dtype=buf.dtype, device=buf.device
                           ).index_add_(0, rows,
                                        vals * buf.index_select(0, cols))

    def matvec(x, *, data=None):
        y = local(x_chunk(x), data)
        return DTensor.from_local(y[:local_rows], mesh, placements,
                                  run_check=False, shape=(n,), stride=(1,))

    matvec.plan = plan
    matvec.tier = "pallas" if pallas else "segment_sum"
    matvec.local = local
    return matvec

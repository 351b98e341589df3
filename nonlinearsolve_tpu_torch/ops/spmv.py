"""Sparse matrix-vector products: the port of ``ops/pallas_spmv.py``'s tier
selection, CSR and BSR entry points, and the kernels K4, K5 and K6.

Kernels (CUDA C++ for ``sm_90a`` in ``csrc/spmv.cu``; its header gives
their bounds and design):

- K4 ``dia_spmv(dd, offsets, x)``: ``y[i] = Σ_d dd[d, i]·x[i + off_d]``
  over the in-band slots only, in ascending-offset order.  It replaces
  ``ops/pallas_stencil.py`` ``dia_spmv_pallas`` and is the function of
  ``DIA.matvec`` / ``DiaPlan.matvec_packed``.
- K5 ``gather_spmv(indptr, indices, data, x)``: the CSR product, summed in
  CSR order.  It replaces ``ops/pallas_spmv.py`` ``_ell_spmv_call``.
- K5's unit-data variant ``gather_select(src, values)``:
  ``y[i] = values[src[i]]``, 0 where ``src[i] == n_src`` (a pad): the
  static selection of ``ops/selection.py``.
- K6 ``bsr_spmm(bsr, X)``: ``Y = A·X`` for A in BSR and a dense
  multi-RHS X, each block row's blocks in CSR order, launched with the
  team shape ``bsr_spmm_plan`` picks.  It replaces ``ops/pallas_spmv.py``
  ``_bsr_spmm_call`` (``bsr_spmm_pallas``).

``bsr_spmv`` (``BSR.matvec`` on the card) is K5 on the scalar pattern that
``bsr_scalar_pattern`` expands from the blocks, as the JAX package's
``bsr_spmv_pallas`` is.  K7 (``ops/spmv_stream.py``) and K8
(``ops/spmv_scatter.py``) live in the same source.  Each wrapper takes its plain PyTorch version (``*_plain``)
for a tensor on the CPU, and only there.  For a CUDA tensor it checks
device, dtype, shape and contiguity, launches the kernel on the current
stream and counts the launch in ``_backend.LAUNCHES``; anything the kernel
does not take raises.

Tier selection is the JAX package's, to the bit (``select_spmv_plan``):
"dia", "resident", "stream", "scatter" or None, by its op-count model of
the TPU kernels, with RCM reordering where that makes a plan fit.  The
port routes the tiers to its kernels (``csr_route``, one ``SpmvRoute``
per pattern): "dia" to K4, "stream" to K7, "scatter" to K8, "resident"
and None to K5 on the pattern as given.  ``csr_spmv_staged`` and
``csr_spmv`` both launch through the route.

Reverse rules: ``csr_spmv`` (``CSR.matvec``) is ``SpmvFunction`` on the
tier's route: x̄ = Aᵀȳ by the same kernel on Aᵀ's tables, d̄ata =
ȳ[row]·x[col] (the JAX package's custom VJPs of K5, K7 and K8; on the
"dia" tier K4 on Aᵀ's diagonals).  ``DIA.matvec`` has ``DiaFunction``,
the K5 product of a BSR the same ``SpmvFunction``.  The bare wrappers
refuse grad and forward-mode tangents (``_backend.refuse_grad``): K4 and
K6 have no reverse rule, as in the JAX package, and K5, K7 and K8 name
``csr_spmv``.  No kernel has a forward-mode rule.
"""

from __future__ import annotations

import ctypes
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from .. import _backend

_VP = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "dia_spmv_f32": [_VP, _VP, _VP, _I, _VP, _I, _VP],
    "dia_spmv_f64": [_VP, _VP, _VP, _I, _VP, _I, _VP],
    "csr_spmv_f32": [_VP] * 5 + [_I, _VP],
    "csr_spmv_f64": [_VP] * 5 + [_I, _VP],
    "csr_select_f32": [_VP] * 3 + [_I, _I, _VP],
    "csr_select_f64": [_VP] * 3 + [_I, _I, _VP],
    "band_spmv_f32": [_VP] * 4 + [_I, _I, ctypes.c_longlong, _I, _VP],
    "band_spmv_f64": [_VP] * 4 + [_I, _I, ctypes.c_longlong, _I, _VP],
    "scatter_part_f32": [_VP] * 7 + [_I] * 7 + [_VP],
    "scatter_part_f64": [_VP] * 7 + [_I] * 7 + [_VP],
    "bsr_spmm_f32": [_VP] * 5 + [_I] * 7 + [_VP],
    "bsr_spmm_f64": [_VP] * 5 + [_I] * 7 + [_VP],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
MAX_OFFSETS = 48            # the kernel's by-value offset table
_INT32_MAX = 2 ** 31 - 1


def _lib():
    return _backend.load("spmv", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference the kernels are
# held against on the card)
# ---------------------------------------------------------------------------

def dia_spmv_plain(dd, offsets, x):
    """The zero-fill shifted chain of ``DIA.matvec``: each diagonal
    multiplies its valid region only, so pad slots are never read."""
    n = x.shape[0]
    out = None
    for d, off in enumerate(offsets):
        off = int(off)
        if off == 0:
            seg = dd[d] * x
        elif abs(off) >= n:
            seg = torch.zeros_like(x)
        elif off > 0:
            seg = torch.cat([dd[d, :n - off] * x[off:], x.new_zeros(off)])
        else:
            seg = torch.cat([x.new_zeros(-off), dd[d, -off:] * x[:off]])
        out = seg if out is None else out + seg
    return torch.zeros_like(x) if out is None else out


def gather_spmv_plain(indptr, indices, data, x):
    """``index_select`` of x, the products, then ``index_add_`` by row (the
    row of entry k found by a search in indptr: no host sync)."""
    n_rows = indptr.shape[0] - 1
    k = torch.arange(indices.shape[0], dtype=indptr.dtype, device=x.device)
    rows = torch.searchsorted(indptr[1:], k, right=True)
    prod = data * x.index_select(0, indices.long())
    return torch.zeros(n_rows, dtype=x.dtype, device=x.device).index_add_(
        0, rows, prod)


def gather_select_plain(src, values):
    """``values_ext[src]`` with a zero appended for the pad index."""
    ext = torch.cat([values, values.new_zeros(1)])
    return ext[src.long()]


# ---------------------------------------------------------------------------
# checks shared by the wrappers
# ---------------------------------------------------------------------------

def _check(name, t, dtype, device, ndim):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-d, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _value_dtype(t):
    if t.dtype not in _SUFFIX:
        raise TypeError(f"kernel takes float32 or float64, got {t.dtype}")
    return t.dtype


def _fits_int32(name, n):
    if n > _INT32_MAX:
        raise ValueError(f"{name} = {n} exceeds the kernel's int32 range")


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------

def dia_spmv(dd, offsets, x):
    """``y[i] = Σ_d dd[d, i]·x[i + offsets[d]]`` with ``dd`` (ndiag, n) and
    ``x`` (n,); slots whose column falls outside [0, n) are not read."""
    _backend.refuse_grad("K4 dia_spmv", dd, x)
    if x.device.type == "cpu":
        return dia_spmv_plain(dd, offsets, x)
    dtype = _value_dtype(x)
    n = x.shape[0]
    ndiag = len(offsets)
    if ndiag > MAX_OFFSETS:
        raise ValueError(f"{ndiag} diagonals: the kernel takes at most "
                         f"{MAX_OFFSETS}")
    _check("x", x, dtype, x.device, 1)
    _check("dd", dd, dtype, x.device, 2)
    if tuple(dd.shape) != (ndiag, n):
        raise ValueError(f"dd has shape {tuple(dd.shape)}, expected "
                         f"{(ndiag, n)}")
    _fits_int32("n", n)
    offs = np.ascontiguousarray(
        np.clip(np.asarray(offsets, np.int64), -n, n), np.int32)
    y = torch.empty_like(x)
    lib = _lib()
    rc = getattr(lib, f"dia_spmv_{_SUFFIX[dtype]}")(
        _backend.ptr(dd), _backend.ptr(x), _backend.ptr(y), n,
        offs.ctypes.data_as(ctypes.c_void_p), ndiag,
        _backend.stream_handle(x))
    _backend.check_launch(lib, rc, "dia_spmv")
    _backend.count_launch("dia_spmv")
    return y


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def gather_spmv(indptr, indices, data, x):
    """``y = A·x`` for A in CSR (``indptr``, ``indices`` int32 tensors on
    x's device, ``data`` (nnz,)); ``x`` is (n_cols,)."""
    _backend.refuse_grad("K5 gather_spmv", data, x, via="csr_spmv")
    if x.device.type == "cpu":
        return gather_spmv_plain(indptr, indices, data, x)
    dtype = _value_dtype(x)
    _check("x", x, dtype, x.device, 1)
    _check("data", data, dtype, x.device, 1)
    _check("indptr", indptr, torch.int32, x.device, 1)
    _check("indices", indices, torch.int32, x.device, 1)
    if indices.shape[0] != data.shape[0]:
        raise ValueError("indices and data differ in length")
    n_rows = indptr.shape[0] - 1
    y = torch.empty(n_rows, dtype=dtype, device=x.device)
    lib = _lib()
    rc = getattr(lib, f"csr_spmv_{_SUFFIX[dtype]}")(
        _backend.ptr(indptr), _backend.ptr(indices), _backend.ptr(data),
        _backend.ptr(x), _backend.ptr(y), n_rows, _backend.stream_handle(x))
    _backend.check_launch(lib, rc, "gather_spmv")
    _backend.count_launch("gather_spmv")
    return y


def gather_select(src, values):
    """``y[i] = values[src[i]]``, and 0 where ``src[i] == len(values)``;
    ``src`` is an int32 tensor on the values' device."""
    _backend.refuse_grad("K5 gather_select", values)
    if values.device.type == "cpu":
        return gather_select_plain(src, values)
    dtype = _value_dtype(values)
    _check("values", values, dtype, values.device, 1)
    _check("src", src, torch.int32, values.device, 1)
    n_src = values.shape[0]
    _fits_int32("n_src", n_src)
    y = torch.empty(src.shape[0], dtype=dtype, device=values.device)
    lib = _lib()
    rc = getattr(lib, f"csr_select_{_SUFFIX[dtype]}")(
        _backend.ptr(src), _backend.ptr(values), _backend.ptr(y),
        src.shape[0], n_src, _backend.stream_handle(values))
    _backend.check_launch(lib, rc, "gather_select")
    _backend.count_launch("gather_select")
    return y


# ---------------------------------------------------------------------------
# BSR: K5 on the expanded scalar pattern for SpMV; K6 for SpMM
# ---------------------------------------------------------------------------

_BSR_EXPAND_CACHE: dict = {}


def bsr_scalar_pattern(bsr) -> tuple:
    """The scalar CSR pattern of a BSR block pattern, ``(indptr, indices,
    take_order)`` (int64, host, cached by pattern), where ``take_order``
    maps the flattened (nblocks, b, b) data into CSR nonzero order.  Each
    block row's blocks are sorted stably by column, and scalar row i·b + r
    holds row r of each of them in turn: the JAX package's
    ``bsr_scalar_pattern``, array for array, without its loop over rows."""
    key = pattern_key(bsr.indptr, bsr.indices, *bsr.shape, bsr.blocksize)
    hit = _BSR_EXPAND_CACHE.get(key)
    if hit is not None:
        return hit
    b = bsr.blocksize
    bptr = np.asarray(bsr.indptr, np.int64)
    bcol = np.asarray(bsr.indices, np.int64)
    counts = np.diff(bptr)
    nblocks = bcol.shape[0]
    brow = np.repeat(np.arange(counts.shape[0], dtype=np.int64), counts)
    order = np.argsort(brow * (int(bcol.max(initial=0)) + 1) + bcol,
                       kind="stable")
    row_s, col_s = brow[order], bcol[order]
    start, cnt = bptr[:-1][row_s], counts[row_s]
    rr = np.arange(b, dtype=np.int64)
    # block j (in sorted order) puts its row r at slots
    # b²·start + r·b·cnt + (j − start)·b + c of the scalar pattern
    pos = ((b * b * start + (np.arange(nblocks) - start) * b)[:, None, None]
           + (b * cnt)[:, None, None] * rr[None, :, None]
           + rr[None, None, :])
    indices = np.empty(nblocks * b * b, np.int64)
    take = np.empty(nblocks * b * b, np.int64)
    indices[pos] = (col_s * b)[:, None, None] + rr[None, None, :]
    take[pos] = ((order * b * b)[:, None, None] + rr[None, :, None] * b
                 + rr[None, None, :])
    indptr = np.concatenate([[0], np.cumsum(np.repeat(b * counts, b))]
                            ).astype(np.int64)
    out = (indptr, indices, take)
    _BSR_EXPAND_CACHE[key] = out
    return out


def bsr_spmv(bsr, x):
    """``y = A·x`` for A in BSR: K5 (``gather_spmv``) on the expanded scalar
    pattern (its int32 tables cached per pattern and device); the data
    reshuffle is one static take, as in the JAX package's
    ``bsr_spmv_pallas``."""
    _indptr, _indices, take = bsr.scalar_tables(x.device)
    data = bsr.data.reshape(-1).index_select(0, take)
    return SpmvFunction.apply(data, x, bsr_route(bsr))


def bsr_spmm_plain(bsr, X):
    """The JAX package's XLA route of ``bsr_spmm_pallas`` in torch: the X
    blocks gathered by block column, one batched (b, b)·(b, nrhs) product,
    then ``index_add_`` by block row; accumulated in f32 (f64 for f64
    data), returned in X's dtype."""
    b = bsr.blocksize
    n, m = bsr.shape
    _indptr, _indices, cols, brow = bsr.device_tables(X.device)
    acc = torch.float64 if bsr.data.dtype == torch.float64 else torch.float32
    gathered = X.reshape(m // b, b, X.shape[1]).index_select(0, cols)
    prods = torch.einsum("nij,njr->nir", bsr.data.to(acc), gathered.to(acc))
    out = torch.zeros((n // b, b, X.shape[1]), dtype=acc, device=X.device)
    return out.index_add_(0, brow, prods).to(X.dtype).reshape(n, X.shape[1])


# K6's launch: csrc/spmv.cu instantiates its kernel for these block sizes
# (any other b takes the generic one, one column a load, nothing staged),
# holds at most BSR_MAX_VALUES values of X a lane for each block, and stages
# a thread block's blocks in shared memory in chunks of at most
# BSR_STAGE_BYTES.
BSR_BLOCK_SIZES = (1, 2, 3, 4, 8)
BSR_THREADS = 256
BSR_MAX_VALUES = 8
BSR_STAGE_BYTES = 48 * 1024


class BsrPlan(NamedTuple):
    """K6's launch: the instantiated block size (0: the generic kernel),
    X's and Y's values a load or store, column slots a lane, and a team of
    ``2**team_shift`` lanes a block row (``BSR_THREADS >> team_shift``
    block rows a thread block).  Lane l of a team computes the columns
    ``p + s·vec·2**team_shift + l·vec + [0, vec)`` for ``s < cols_per_lane``,
    in passes ``p`` of ``vec·cols_per_lane·2**team_shift`` columns."""
    block: int
    vec: int
    cols_per_lane: int
    team_shift: int


def bsr_spmm_plan(b: int, nrhs: int, itemsize: int, x_addr: int) -> BsrPlan:
    """K6's plan for block size ``b``, ``nrhs`` columns of ``itemsize``
    bytes and an X at address ``x_addr``: 16-byte loads (4 f32 or 2 f64
    columns; else 2 f32) where nrhs and X's address allow them; then for
    g column groups (of vec columns) one pass of the smallest team that
    covers them where g ≤ 8, else teams of 8 lanes with two slots a lane
    in passes of 16 groups, or, where a lane cannot hold two slots and in
    the generic kernel, the smallest team of at most 32 lanes that covers
    them.  Narrow teams keep 32 or more block rows in a thread block, over
    which its staging is spread (``bench/k6_designs.cu`` times the
    alternatives)."""
    block = b if b in BSR_BLOCK_SIZES else 0
    vec = 1
    for v in (16 // itemsize, 2):
        if (block and v > 1 and nrhs % v == 0 and x_addr % (v * itemsize) == 0
                and block * v <= BSR_MAX_VALUES):
            vec = v
            break
    groups = max(1, -(-nrhs // vec))
    if groups <= 8:
        cols, team = 1, groups
    elif block and block * vec * 2 <= BSR_MAX_VALUES:
        cols, team = 2, 8
    else:
        cols, team = 1, min(groups, 32)
    return BsrPlan(block, vec, cols, (team - 1).bit_length())


def bsr_stage_blocks(indptr, b: int, itemsize: int, team_shift: int) -> int:
    """K6's chunk of blocks in shared memory: the most that any thread
    block's ``BSR_THREADS >> team_shift`` block rows hold (so that each
    thread block stages its blocks once), at least 1 and at most as many
    as ``BSR_STAGE_BYTES`` takes (a thread block with more stages them in
    chunks); 0 for a block size the generic kernel takes (nothing
    staged)."""
    if b not in BSR_BLOCK_SIZES:
        return 0
    rows = BSR_THREADS >> team_shift
    ptr = np.asarray(indptr, np.int64)
    starts = np.arange(0, len(ptr) - 1, rows)
    ends = np.minimum(starts + rows, len(ptr) - 1)
    most = int((ptr[ends] - ptr[starts]).max(initial=0))
    return max(1, min(most, BSR_STAGE_BYTES // (b * b * itemsize + 4)))


def bsr_spmm(bsr, X):
    """``Y = A·X`` for A in BSR (``data`` (nblocks, b, b)) and a dense X
    (n_cols, nrhs) of the data's dtype: K6, launched with
    ``bsr_spmm_plan``.  An empty Y (no rows or no columns) comes back
    without a launch."""
    _backend.refuse_grad("K6 bsr_spmm", bsr.data, X)
    data = bsr.data
    if X.dtype != data.dtype:
        raise TypeError(f"X has dtype {X.dtype} and the BSR data "
                        f"{data.dtype}: they must be equal")
    if X.dim() != 2 or X.shape[0] != bsr.shape[1]:
        raise ValueError(f"X has shape {tuple(X.shape)}, expected "
                         f"({bsr.shape[1]}, nrhs)")
    if X.device != data.device:
        raise ValueError(f"X is on {X.device}, the BSR data on "
                         f"{data.device}")
    if X.device.type == "cpu":
        return bsr_spmm_plain(bsr, X)
    dtype = _value_dtype(X)
    b = bsr.blocksize
    _check("X", X, dtype, X.device, 2)
    _check("data", data, dtype, X.device, 3)
    if tuple(data.shape) != (bsr.indices.shape[0], b, b):
        raise ValueError(f"data has shape {tuple(data.shape)}, expected "
                         f"{(bsr.indices.shape[0], b, b)}")
    n, nrhs = bsr.shape[0], X.shape[1]
    Y = torch.empty((n, nrhs), dtype=dtype, device=X.device)
    if Y.numel() == 0:
        return Y
    indptr, indices, _cols, _brow = bsr.device_tables(X.device)
    item = X.element_size()
    plan = bsr_spmm_plan(b, nrhs, item, X.data_ptr())
    key = ("k6_stage", plan.team_shift, item)
    if key not in bsr._shared:
        bsr._shared[key] = bsr_stage_blocks(bsr.indptr, b, item,
                                            plan.team_shift)
    lib = _lib()
    rc = getattr(lib, f"bsr_spmm_{_SUFFIX[dtype]}")(
        _backend.ptr(indptr), _backend.ptr(indices), _backend.ptr(data),
        _backend.ptr(X), _backend.ptr(Y), n // b, b, nrhs, plan.vec,
        plan.cols_per_lane, plan.team_shift, bsr._shared[key],
        _backend.stream_handle(X))
    _backend.check_launch(lib, rc, "bsr_spmm")
    _backend.count_launch("bsr_spmm")
    return Y


# ---------------------------------------------------------------------------
# tier selection: the JAX package's host planning and its op-count model
# ---------------------------------------------------------------------------
#
# The constants, the EllPlan acceptance and the cost model are the JAX
# package's (ops/pallas_spmv.py), kept as module attributes so that tests
# can lower the caps on both sides.  They describe the TPU kernels' envelope
# and vector-op costs: the port keeps them so that its tier is the JAX
# package's for every pattern, not as a model of the H100.

LANES = 128
SUBLANES = 8
ROWS_PER_TILE = SUBLANES * LANES
MAX_X_ELEMS_VMEM = (10 * 1024 * 1024) // 4
MAX_WINDOW_ROWS = 512
MAX_SLOTS = 32
_SMEM_R0_CAP_BYTES = 24 * 1024
_UNROLL_G = 8
# the JAX package's TPU constants of its dia-tier cost (ops/pallas_spmv.py)
HBM_BYTES_PER_S = 2.2e12
VPU_VEC_OPS_PER_S = 4 * 940e6
_LOOP_WALK_DERATE = 4.0
_SCATTER_TRY_THRESHOLD = 0.35


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _unique_sorted(offs, lo, hi) -> np.ndarray:
    """``np.unique(offs)`` for integers in [lo, hi]: one counting pass
    instead of a sort of every nonzero."""
    seen = np.bincount(offs - lo, minlength=hi - lo + 1)
    return np.flatnonzero(seen).astype(np.int64) + lo


def pattern_key(indptr, indices, *extra) -> tuple:
    """Cache key for a static sparsity pattern: sha1 over (indptr, indices)
    as int64, plus any extra static scalars (the JAX package's key)."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(np.asarray(indptr, np.int64)))
    h.update(np.ascontiguousarray(np.asarray(indices, np.int64)))
    return (h.hexdigest(),) + tuple(int(e) for e in extra)


def transpose_pattern_of(indptr, indices, n_rows, n_cols):
    """(tindptr, tindices, tperm): the CSR pattern of Aᵀ plus the
    permutation mapping A's data order into Aᵀ's (each column's rows
    ascending: the JAX package's lexsort order).  Host; SciPy's linear-time
    CSR → CSC conversion with the positions as data."""
    import scipy.sparse as sp
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    pos = np.arange(indices.shape[0], dtype=np.int64)
    csc = sp.csr_matrix((pos, indices, indptr),
                        shape=(int(n_rows), int(n_cols))).tocsc()
    return (csc.indptr.astype(np.int64), csc.indices.astype(np.int64),
            csc.data.astype(np.int64))


class EllPlan:
    """The acceptance and cost fields of the JAX package's slot-major
    windowed ELL plan (``ops/pallas_spmv.py`` ``EllPlan``): ``w`` (max nnz a
    row), ``n_pad`` (rows padded to 1024·rt), ``W`` (window height in x-tile
    rows), ``mode`` ("slot" or "group"), ``supported``, and ``table_size``
    (w·n_pad, the size of its slot tables).  The TPU's window tables are not
    built.  When the pattern is outside the envelope for a reason the
    windows cannot change (``n_cols`` above ``MAX_X_ELEMS_VMEM``, or ``w``
    above ``MAX_SLOTS``), the windows are not computed (``W``, ``mode`` and
    ``nx_rows`` are None): the JAX package never reads them for an
    unsupported plan.  ``min_w``, ``min_W`` and ``force_mode`` are the JAX
    plan's lower bounds on the slot count and window height and its forced
    window granularity, which give the shards of a row-partitioned
    operator one kernel shape (``parallel/sparse_dist.py``); ``nx_rows`` is
    its padded x-buffer height in tile rows and ``r0_size`` the entries of
    its window-start table."""

    def __init__(self, indptr, indices, n_rows, n_cols, *, rt=1, min_w=1,
                 min_W=SUBLANES, force_mode=None):
        indptr = np.asarray(indptr, np.int64)
        indices = np.asarray(indices, np.int64)
        counts = np.diff(indptr)
        w = max(int(counts.max()) if counts.size else 1, 1, int(min_w))
        self.rt = max(int(rt), 1)
        n_pad = _round_up(max(n_rows, 1), ROWS_PER_TILE * self.rt)
        self.w, self.n_pad = w, n_pad
        self.n_rows, self.n_cols = int(n_rows), int(n_cols)
        self.ntiles = n_pad // ROWS_PER_TILE
        self.table_size = w * n_pad
        self.W = self.mode = self.nx_rows = self.r0_size = None
        self.supported = False
        if n_cols > MAX_X_ELEMS_VMEM or w > MAX_SLOTS:
            return
        # per (128-row group, slot): the x-tile rows its columns span; an
        # empty (group, slot) counts as tile row 0, as in the JAX plan
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
        slots = np.arange(len(indices), dtype=np.int64) - indptr[:-1][rows]
        groups = n_pad // LANES
        hi = indices // LANES
        hi_min = np.full((w, n_pad), np.iinfo(np.int64).max, np.int64)
        hi_max = np.full((w, n_pad), -1, np.int64)
        hi_min[slots, rows] = hi
        hi_max[slots, rows] = hi
        hi_min_s = hi_min.reshape(w, groups, LANES).min(axis=2)
        hi_max_s = hi_max.reshape(w, groups, LANES).max(axis=2)
        del hi_min, hi_max
        empty = hi_max_s < 0
        hi_min_s = np.where(empty, 0, hi_min_s)
        hi_max_s = np.where(empty, 0, hi_max_s)
        r0_s = (hi_min_s // SUBLANES) * SUBLANES
        Ws = _round_up(max(int((hi_max_s - r0_s + 1).max()), 1,
                           int(min_W)), SUBLANES)
        hi_min_g = hi_min_s.min(axis=0)
        hi_max_g = hi_max_s.max(axis=0)
        r0_g = (hi_min_g // SUBLANES) * SUBLANES
        Wg = _round_up(max(int((hi_max_g - r0_g + 1).max()), 1,
                           int(min_W)), SUBLANES)
        Gs, Gg = Ws // SUBLANES, Wg // SUBLANES
        if force_mode is not None:
            self.mode = force_mode
        else:
            self.mode = "slot" if 3 * w * Gs < (2 * w + 1) * Gg else "group"
        self.W = Ws if self.mode == "slot" else Wg
        self.nx_rows = max(_round_up(-(-max(int(n_cols), 1) // LANES),
                                     SUBLANES), self.W)
        self.r0_size = self.ntiles * SUBLANES * (w if self.mode == "slot"
                                                 else 1)
        self.supported = self.W <= MAX_WINDOW_ROWS


_PLAN_CACHE: dict = {}


def _default_rt(indptr, n_rows) -> int:
    """Row-tiles per grid step of the JAX package's resident tier (it
    changes ``n_pad``, and so the plan's cost)."""
    counts = np.diff(np.asarray(indptr, np.int64))
    w = max(int(counts.max()) if counts.size else 1, 1)
    rt = max(1, min(16, 16 // min(w, 16)))
    while rt > 1 and rt * ROWS_PER_TILE > max(int(n_rows), 1):
        rt //= 2
    return rt


def ell_plan_for(indptr, indices, n_rows, n_cols) -> EllPlan:
    """The pattern's resident-tier plan (host, cached by pattern)."""
    key = pattern_key(indptr, indices, n_rows, n_cols)
    plan = _PLAN_CACHE.get(key)
    if plan is None:
        plan = EllPlan(indptr, indices, int(n_rows), int(n_cols),
                       rt=_default_rt(indptr, n_rows))
        _PLAN_CACHE[key] = plan
    return plan


_REORDER_CACHE: dict = {}
_RCM_PATTERN_CACHE: dict = {}


def _rcm_pattern(indptr, indices, n_rows):
    """RCM symmetric permutation of a square pattern: (perm, pinv, dperm,
    new_indptr, new_indices), ``perm[new] = old`` and ``dperm`` the data
    order of the reordered CSR.  Host, cached."""
    key = pattern_key(indptr, indices, n_rows)
    hit = _RCM_PATTERN_CACHE.get(key)
    if hit is not None:
        return hit
    from ..native import rcm_ordering
    perm = np.asarray(rcm_ordering(indptr, indices, n_rows), np.int64)
    pinv = np.empty(n_rows, np.int64)
    pinv[perm] = np.arange(n_rows)
    indptr64 = np.asarray(indptr, np.int64)
    row_ids = np.repeat(np.arange(n_rows, dtype=np.int64),
                        np.diff(indptr64))
    new_row = pinv[row_ids]
    new_col = pinv[np.asarray(indices, np.int64)]
    # lexsort((new_col, new_row)) as one stable sort of a combined key
    dperm = np.argsort(new_row * n_rows + new_col, kind="stable")
    new_indices = new_col[dperm]
    new_indptr = np.concatenate(
        [[0], np.cumsum(np.bincount(new_row, minlength=n_rows))])
    out = (perm, pinv, dperm, new_indptr, new_indices)
    _RCM_PATTERN_CACHE[key] = out
    return out


def _plan_maybe_reordered(indptr, indices, n_rows, n_cols):
    """(plan, perm, pinv, dperm): the direct resident plan when it is
    supported, else the RCM-reordered one when that is.  The RCM is skipped
    where the plan has no windows (``n_cols`` or ``w`` beyond the envelope):
    a symmetric permutation changes neither, so no reorder can help."""
    key = pattern_key(indptr, indices, n_rows, n_cols)
    hit = _REORDER_CACHE.get(key)
    if hit is not None:
        return hit
    plan = ell_plan_for(indptr, indices, n_rows, n_cols)
    out = (plan, None, None, None)
    if not plan.supported and n_rows == n_cols and plan.W is not None:
        perm, pinv, dperm, new_indptr, new_indices = _rcm_pattern(
            indptr, indices, n_rows)
        rplan = ell_plan_for(new_indptr, new_indices, n_rows, n_cols)
        if rplan.supported:
            out = (rplan, perm, pinv, dperm)
    _REORDER_CACHE[key] = out
    return out


def spmv_tier_cost(tier, plan) -> float:
    """The JAX package's weighted vector-op count per 128-row group, which
    orders its tiers (``ops/pallas_spmv.py`` ``spmv_tier_cost``)."""
    if tier == "resident":
        G = plan.W // SUBLANES
        if plan.mode == "slot":
            return 12.0 * plan.w * G
        return (12.0 * plan.w + 2.0) * G
    if tier == "stream":
        return 14.0 * sum(m * span for (_l, _h, m, _b, span, _g)
                          in plan.bands)
    if tier == "scatter":
        return plan.cost / max(plan.n_pad / LANES, 1.0)
    if tier == "dia":
        hbm_equiv = (VPU_VEC_OPS_PER_S * (8.0 * plan.ndiag + 8.0) * LANES
                     / HBM_BYTES_PER_S)
        return max(hbm_equiv, 0.25 * plan.ndiag)
    return float("inf")


def _derated_cost(tier, plan) -> float:
    c = spmv_tier_cost(tier, plan)
    if tier == "resident" and plan.W // SUBLANES > _UNROLL_G:
        c *= _LOOP_WALK_DERATE
    return c


_TIER_CACHE: dict = {}


def select_spmv_plan(indptr, indices, n_rows, n_cols):
    """The JAX package's tier for a pattern, ``(tier, plan, perm, pinv,
    dperm)`` (``ops/pallas_spmv.py`` ``select_spmv_plan``): "dia",
    "resident", "stream" or "scatter" by the least derated cost, the
    scatter plan built only when no other tier fits or the best one costs
    more than ``_SCATTER_TRY_THRESHOLD`` per nonzero; ``(None,)*5`` when no
    tier fits.  ``perm`` is set when the plan is of the RCM-reordered
    pattern.  Host, cached by pattern; ``CSR.tier`` keeps the answer on the
    pattern."""
    key = pattern_key(indptr, indices, n_rows, n_cols)
    hit = _TIER_CACHE.get(key)
    if hit is not None:
        return hit
    from .spmv_dia import dia_plan_for
    from .spmv_stream import band_plan_for
    plan, perm, pinv, dperm = _plan_maybe_reordered(
        indptr, indices, n_rows, n_cols)
    candidates = []
    dplan = dia_plan_for(indptr, indices, n_rows, n_cols)
    if dplan.supported:
        candidates.append(("dia", dplan, None, None, None))
    if plan.supported:
        candidates.append(("resident", plan, perm, pinv, dperm))
    bplan = band_plan_for(indptr, indices, n_rows, n_cols)
    if bplan.supported:
        candidates.append(("stream", bplan, None, None, None))
    if not candidates and n_rows == n_cols:
        rperm, rpinv, rdperm, new_indptr, new_indices = _rcm_pattern(
            indptr, indices, n_rows)
        rbplan = band_plan_for(new_indptr, new_indices, n_rows, n_cols)
        if rbplan.supported:
            candidates.append(("stream", rbplan, rperm, rpinv, rdperm))
    nnz = max(len(np.asarray(indices)), 1)
    if candidates:
        best_pn = min(_derated_cost(c[0], c[1]) for c in candidates) \
            * (_round_up(max(n_rows, 1), ROWS_PER_TILE) / LANES) / nnz
    if not candidates or best_pn > _SCATTER_TRY_THRESHOLD:
        from .spmv_scatter import scatter_plan_for
        splan = scatter_plan_for(indptr, indices, n_rows, n_cols)
        if splan.supported:
            candidates.append(("scatter", splan, None, None, None))
    if candidates:
        out = min(candidates, key=lambda c: _derated_cost(c[0], c[1]))
    else:
        out = (None, None, None, None, None)
    _TIER_CACHE[key] = out
    return out


def clear_plan_caches() -> None:
    """Empty every pattern-keyed plan cache of the tiers."""
    from ..parallel import sparse_dist
    from . import spmv_dia, spmv_scatter, spmv_stream
    for cache in (_TIER_CACHE, _PLAN_CACHE, _REORDER_CACHE,
                  sparse_dist._PLAN_CACHE,
                  _RCM_PATTERN_CACHE, _BSR_EXPAND_CACHE,
                  spmv_dia._DIA_PLAN_CACHE,
                  spmv_stream._BAND_PLAN_CACHE,
                  spmv_scatter._SCATTER_PLAN_CACHE):
        cache.clear()


# ---------------------------------------------------------------------------
# the CSR entry points, routed by tier, and the reverse rules of K5, K7 and
# K8 (and of the DIA tier's K4)
# ---------------------------------------------------------------------------

class SpmvRoute:
    """One pattern's product ``y = A·x`` on one kernel, and what its
    reverse rule reads.  ``kind``: "gather" (K5 on the pattern), "dia" (the
    repack, then K4), "stream" (the band repack, then K7), "scatter" (the
    G staging, then K8 a part) or "segment_sum" (the products and
    ``index_add_`` by row: the JAX package's XLA route where no plan of the
    kind fits Aᵀ).  ``plan`` is the kind's plan of this pattern;
    ``pattern`` a ``CSR`` whose ``device_tables`` and ``row_table`` the
    route reads (its data is not used)."""

    def __init__(self, kind, plan, pattern):
        self.kind, self.plan, self.pattern = kind, plan, pattern
        self.shape = pattern.shape
        self._transpose = None

    def staged(self, data):
        """The closure ``x ↦ A·x`` for A's CSR-ordered ``data``: the kind's
        staging once, then its kernel per product."""
        kind, plan = self.kind, self.plan
        if kind == "dia":
            from .spmv_dia import dia_spmv_staged
            return dia_spmv_staged(plan, data)
        if kind == "stream":
            from .spmv_stream import band_spmv_staged
            return band_spmv_staged(plan, data)
        if kind == "scatter":
            from .spmv_scatter import scatter_spmv_staged
            return scatter_spmv_staged(plan, data)
        indptr, indices = self.pattern.device_tables(data.device)
        if kind == "gather":
            return lambda x: gather_spmv(indptr, indices, data, x)
        rows = self.pattern.row_table(data.device)
        n_rows = self.shape[0]
        return lambda x: torch.zeros(
            n_rows, dtype=x.dtype, device=x.device).index_add_(
            0, rows, data * x.index_select(0, indices))

    def transpose(self):
        """``(route of Aᵀ, tperm)``: the same kind on Aᵀ's pattern when its
        plan of that kind fits (K5 takes any pattern), else "segment_sum";
        ``tperm`` maps A's data order into Aᵀ's.  A structurally symmetric
        pattern is its own transpose: the route itself, plan and tables.
        Built once a route."""
        if self._transpose is None:
            from .sparse import CSR
            p = self.pattern
            n_rows, n_cols = self.shape
            tindptr, tindices, tperm = transpose_pattern_of(
                p.indptr, p.indices, n_rows, n_cols)
            if (n_rows == n_cols and np.array_equal(tindptr, p.indptr)
                    and np.array_equal(tindices, p.indices)):
                troute = self
            else:
                kind, plan = self.kind, None
                if kind in ("dia", "stream", "scatter"):
                    plan = _kind_plan(kind, tindptr, tindices, n_cols, n_rows)
                    if not plan.supported:
                        kind, plan = "segment_sum", None
                troute = SpmvRoute(kind, plan, CSR(None, tindices, tindptr,
                                                   (n_cols, n_rows)))
            self._transpose = (troute, tperm.astype(np.int32), {})
        return self._transpose[:2]

    def tperm(self, device):
        """``tperm`` as an int32 tensor on ``device`` (cached)."""
        _troute, tperm = self.transpose()
        on_device = self._transpose[2]
        key = torch.device(device)
        if key not in on_device:
            on_device[key] = torch.as_tensor(tperm, device=key)
        return on_device[key]


def _kind_plan(kind, indptr, indices, n_rows, n_cols):
    if kind == "dia":
        from .spmv_dia import dia_plan_for
        return dia_plan_for(indptr, indices, n_rows, n_cols)
    if kind == "stream":
        from .spmv_stream import band_plan_for
        return band_plan_for(indptr, indices, n_rows, n_cols)
    from .spmv_scatter import scatter_plan_for
    return scatter_plan_for(indptr, indices, n_rows, n_cols)


def csr_route(csr):
    """``(route, reordered)`` of a CSR's tier (cached with the pattern):

    - "dia": the DIA repack (K5's selection), then K4;
    - "stream": the band repack (K5's selection), then K7; ``reordered``
      when the plan is of the RCM-reordered pattern, whose ``CSR`` the
      route then holds (built from the tier's ``perm`` and ``dperm``);
    - "scatter": the parts' G data staged (K5's selection), then K8's
      expand and regroup passes;
    - "resident": K5 on the pattern as given.  The JAX package's RCM
      reorder only made its TPU windows fit; K5 takes any pattern and gives
      the same y;
    - None: K5.  The JAX package uses XLA's segment_sum there; the port
      keeps its hand-written kernel.

    The route's pattern shares the CSR's device tables."""
    if "route" not in csr._shared:
        from .sparse import CSR
        tier, plan, perm, pinv, dperm = csr.tier
        reordered = tier == "stream" and perm is not None
        if reordered:
            counts = np.diff(csr.indptr.astype(np.int64))[perm]
            pattern = CSR(None, pinv[csr.indices[dperm]],
                          np.concatenate([[0], np.cumsum(counts)]),
                          csr.shape)
        else:
            pattern = CSR(None, csr.indices, csr.indptr, csr.shape,
                          csr._shared)
        kind = tier if tier in ("dia", "stream", "scatter") else "gather"
        csr._shared["route"] = (
            SpmvRoute(kind, None if kind == "gather" else plan, pattern),
            reordered)
    return csr._shared["route"]


def csr_spmv_staged(csr):
    """Staged matvec closure for a Krylov loop, on the tier's route
    (``csr_route``): the route's staging once, with x gathered by ``perm``
    and y by ``pinv`` when the plan is of the RCM-reordered pattern.
    Forward-only, as the JAX package's staged closure is."""
    route, reordered = csr_route(csr)
    data = csr.data
    if not reordered:
        return route.staged(data)
    perm_t, pinv_t, dperm_t = csr.perm_tables(data.device)
    inner = route.staged(data[dperm_t])
    return lambda x: inner(x[perm_t])[pinv_t]


def csr_spmv(csr, x):
    """One product ``A·x`` through the pattern's tier, differentiable in
    ``csr.data`` and in ``x`` (the counterpart of the JAX package's
    ``csr_spmv_pallas``): ``SpmvFunction`` on the tier's route, a "stream"
    plan of the RCM-reordered pattern differentiated through its
    permutations, as there."""
    route, reordered = csr_route(csr)
    data = csr.data
    if not reordered:
        return SpmvFunction.apply(data, x, route)
    perm_t, pinv_t, dperm_t = csr.perm_tables(data.device)
    return SpmvFunction.apply(data[dperm_t], x[perm_t], route)[pinv_t]


class SpmvFunction(torch.autograd.Function):
    """``y = A·x`` on a route, with the reverse rule of the JAX package's
    custom VJPs (``ops/pallas_spmv.py`` ``_ell_spmv_bwd``,
    ``pallas_spmv_stream.py`` ``_band_spmv_bwd``, ``pallas_spmv_scatter.py``
    ``_scatter_spmv_bwd``): x̄ = Aᵀȳ by the route's kernel on Aᵀ's tables
    (``SpmvRoute.transpose``, data permuted by ``tperm``), and
    d̄ata_k = ȳ[row_k]·x[col_k] by ``index_select`` products, which the
    JAX package computes in XLA too.  x̄ goes through this same Function,
    so the rule is differentiable again.  A forward-mode tangent is
    refused, as ``jax.jvp`` through a custom VJP is."""

    @staticmethod
    def forward(data, x, route):
        return route.staged(data)(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        data, x, route = inputs
        ctx.save_for_backward(data, x)
        ctx.route = route

    @staticmethod
    def backward(ctx, gy):
        data, x = ctx.saved_tensors
        route = ctx.route
        gy = gy.contiguous()
        gdata = gx = None
        if ctx.needs_input_grad[0]:
            _indptr, indices = route.pattern.device_tables(gy.device)
            rows = route.pattern.row_table(gy.device)
            gdata = gy.index_select(0, rows) * x.index_select(0, indices)
        if ctx.needs_input_grad[1]:
            troute = route.transpose()[0]
            gx = SpmvFunction.apply(
                data.index_select(0, route.tperm(gy.device)), gy, troute)
        return gdata, gx, None

    @staticmethod
    def jvp(ctx, tdata, tx, _troute):
        raise NotImplementedError(
            f"csr_spmv on the {ctx.route.kind!r} route has no forward-mode "
            f"rule: a tangent (torch.autograd.forward_ad, torch.func.jvp) "
            f"through it is not supported")


def bsr_route(bsr):
    """The K5 route of a BSR's expanded scalar pattern (cached with the
    pattern; ``BSR.scalar_tables`` reads its tables)."""
    if "route" not in bsr._shared:
        from .sparse import CSR
        indptr, indices, _take = bsr_scalar_pattern(bsr)
        bsr._shared["route"] = SpmvRoute(
            "gather", None, CSR(None, indices, indptr, bsr.shape))
    return bsr._shared["route"]


def _dia_shift(rows, offsets, n, transpose):
    """Per diagonal d of offset ``off``: ``rows[d]`` shifted by ``off`` into
    the slots of Aᵀ's diagonal −off (``transpose``), or by −off back;
    slots outside the matrix are 0."""
    out = []
    for d, off in enumerate(offsets):
        off = int(off) if transpose else -int(off)
        r = rows[d]
        if off == 0:
            out.append(r)
        elif abs(off) >= n:
            out.append(torch.zeros_like(r))
        elif off > 0:
            out.append(torch.cat([r.new_zeros(off), r[:n - off]]))
        else:
            out.append(torch.cat([r[-off:], r.new_zeros(-off)]))
    return torch.stack(out)


class DiaFunction(torch.autograd.Function):
    """``DIA.matvec``: K4 forward; x̄ = K4 on Aᵀ's diagonals (offsets −off,
    each diagonal's data shifted by off), d̄d[d, i] = ȳ[i]·x[i + off_d] in
    the valid slots (0 in the rest).  The JAX package's ``DIA.matvec`` is
    an XLA chain that XLA differentiates; this is that gradient with the
    transposed product on the kernel."""

    @staticmethod
    def forward(dd, x, offsets):
        return dia_spmv(dd, offsets, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        dd, x, offsets = inputs
        ctx.save_for_backward(dd, x)
        ctx.offsets = tuple(int(o) for o in offsets)

    @staticmethod
    def backward(ctx, gy):
        dd, x = ctx.saved_tensors
        offs = ctx.offsets
        n = x.shape[0]
        gy = gy.contiguous()
        gdd = gx = None
        if ctx.needs_input_grad[0]:
            # ȳ[i]·x[i + off]: x shifted by off, ȳ in place
            xs = _dia_shift(x.expand(len(offs), n), offs, n, False)
            gdd = gy * xs
        if ctx.needs_input_grad[1]:
            ddt = _dia_shift(dd, offs, n, True).flip(0).contiguous()
            gx = DiaFunction.apply(ddt, gy, tuple(-o for o in offs[::-1]))
        return gdd, gx, None

    @staticmethod
    def jvp(ctx, tdd, tx, _toffsets):
        raise NotImplementedError(
            "K4 dia_spmv (DIA.matvec) has no forward-mode rule: a tangent "
            "(torch.autograd.forward_ad, torch.func.jvp) through it is not "
            "supported")

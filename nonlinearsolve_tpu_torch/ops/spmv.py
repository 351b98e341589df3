"""Sparse matrix-vector products (the port of ``ops/pallas_spmv.py``'s
tier selection and CSR entry points, with the kernels K4 and K5).

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

Each wrapper takes its plain PyTorch version (``*_plain``) for a tensor on
the CPU, and only there.  For a CUDA tensor it checks device, dtype,
shape and contiguity, launches the kernel on the current stream and counts
the launch in ``_backend.LAUNCHES``; anything the kernel does not take
raises.

Tier selection keeps the JAX package's order with the TPU-only tiers taken
out: ``"dia"`` when the pattern's ``DiaPlan`` is supported (few
generalised diagonals), else ``"csr"``.  The resident / stream / scatter
tiers and the RCM reorder existed because the TPU has no scalar gathers;
K5 takes any CSR pattern and returns the same y.
"""

from __future__ import annotations

import ctypes
import hashlib

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
# tier selection and the CSR entry points
# ---------------------------------------------------------------------------

def pattern_key(indptr, indices, *extra) -> tuple:
    """Cache key for a static sparsity pattern: sha1 over (indptr, indices)
    as int64, plus any extra static scalars (the JAX package's key)."""
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(np.asarray(indptr, np.int64)))
    h.update(np.ascontiguousarray(np.asarray(indices, np.int64)))
    return (h.hexdigest(),) + tuple(int(e) for e in extra)


def select_spmv_plan(indptr, indices, n_rows, n_cols):
    """``(tier, plan)``: ``("dia", DiaPlan)`` when the pattern has few
    enough generalised diagonals, else ``("csr", None)``.  Host; the
    ``DiaPlan`` is cached by pattern (``dia_plan_for``), and ``CSR.tier``
    keeps the answer on the pattern."""
    from .spmv_dia import dia_plan_for
    dplan = dia_plan_for(indptr, indices, n_rows, n_cols)
    return ("dia", dplan) if dplan.supported else ("csr", None)


def csr_spmv(csr, x):
    """One product through the pattern's tier: the DIA repack (K5's
    selection) then K4, or K5 on the CSR tables."""
    tier, plan = csr.tier
    if tier == "dia":
        return plan.matvec_packed(plan.pack(csr.data), x)
    indptr, indices = csr.device_tables(x.device)
    return gather_spmv(indptr, indices, csr.data, x)


def csr_spmv_staged(csr):
    """Staged matvec closure for a Krylov loop: on the DIA tier the repack
    runs once here, then every product is one K4 launch; on the CSR tier
    every product is one K5 launch."""
    tier, plan = csr.tier
    if tier == "dia":
        from .spmv_dia import dia_spmv_staged
        return dia_spmv_staged(plan, csr.data)
    indptr, indices = csr.device_tables(csr.data.device)
    data = csr.data

    def mv(x):
        return gather_spmv(indptr, indices, data, x)
    return mv

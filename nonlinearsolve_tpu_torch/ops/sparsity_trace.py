"""Exact sparsity detection by abstract interpretation of the residual's
ATen graph (the port of ``ops/sparsity_trace.py``).

The residual is traced once (``ops/_graph.py``) and a SPARSE boolean
dependency matrix ``deps[element, input_index]`` (scipy CSR, shape
``(numel, n_in)``) is propagated through every node:

* elementwise ops (ATen's ``pointwise`` tag, ``where`` among them, and
  the casts and copies) union their operands' dependencies;
* structural ops (view, reshape, permute, select, slice, unsqueeze,
  squeeze, expand, roll, flip, cat, stack, ``constant_pad_nd``, split,
  unbind, and ``index`` / ``index_select`` / ``gather`` with constant
  indices) are row selections: the element map is found by running the op
  itself on an index array (``arange(numel)`` in int64, −1 where padding
  fills), as the JAX package's ``_gather_map`` does, so no view op has a
  rule of its own;
* ``slice_scatter`` / ``select_scatter`` (slice assignment, JAX's
  ``dynamic_update_slice``) are exact row selections; the scatters with
  constant indices (``index_put``, ``scatter``, ``scatter_add``,
  ``index_add``, ``index_copy``) follow the JAX package's scatter rule:
  the operand's dependencies union the placed updates', and colliding
  accumulated updates union all the update dependencies into every
  touched row;
* reductions and contractions union over the contracted axes; a
  contraction with a constant matrix follows the constant's zeros
  (``_dot_const_exact``).

Traced (data-dependent) indices raise :class:`UnsupportedPrimitive` and the
caller falls back to probing.  Host-side scipy/numpy: a once-per-problem
symbolic pass.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.sparse as sps
import torch

from . import _graph
from ._graph import Ref


class UnsupportedPrimitive(Exception):
    pass


# a value whose dependency matrix exceeds this many set entries is
# unsupported (dependency explosion: such Jacobians are dense anyway)
_NNZ_CAP = 100_000_000

# the casts and copies (the pointwise-tagged ops are elementwise too)
_IDENTITY = {"_to_copy", "alias", "detach", "lift_fresh_copy"}

# views and data movement as they reach the ATen graph (the composite
# ones — reshape, narrow, movedim, flatten, chunk — decompose into these)
_STRUCTURAL = {"view", "_unsafe_view", "permute", "t", "transpose",
               "select", "slice", "unsqueeze", "squeeze", "expand", "roll",
               "flip", "cat", "stack", "constant_pad_nd", "index",
               "index_select", "gather", "take", "repeat", "diagonal",
               "unfold", "split", "split_with_sizes", "unbind",
               "as_strided", "slice_scatter", "select_scatter",
               "diagonal_scatter"}

# scatters with constant indices (the JAX package's scatter rule): the
# operand's dependencies and the updates placed on them; slice_scatter and
# select_scatter (JAX's dynamic_update_slice) are row selections instead
_SCATTERS = {"index_put", "_index_put_impl", "scatter", "scatter_add",
             "scatter_reduce", "index_add", "index_copy"}

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "linalg_vector_norm", "var", "std", "var_mean", "std_mean",
               "any", "all", "argmax", "argmin", "nansum", "aminmax"}

_CUMULATIVE = {"cumsum", "cumprod", "cummax", "cummin", "logcumsumexp"}

# (lhs contracting, rhs contracting, lhs batch, rhs batch)
_CONTRACTIONS = {"mm": ((1,), (0,), (), ()), "mv": ((1,), (0,), (), ()),
                 "dot": ((0,), (0,), (), ()), "bmm": ((2,), (1,), (0,), (0,))}


def _numel(shape) -> int:
    return int(np.prod(shape, dtype=np.int64)) if len(shape) else 1


def _empty_mat(shape, n_in):
    return sps.csr_matrix((_numel(shape), n_in), dtype=bool)


def _check(mat):
    if mat.nnz > _NNZ_CAP:
        raise UnsupportedPrimitive("dependency explosion")
    return mat


def _rows_take(mat, idx, n_in):
    """Row selection out[i] = mat[idx[i]]; idx outside [0, rows) reads a
    zero row (the pad / out-of-bounds sentinel)."""
    idx = np.asarray(idx, np.int64).ravel()
    if np.any((idx < 0) | (idx >= mat.shape[0])):
        mat = sps.vstack(
            [mat, sps.csr_matrix((1, n_in), dtype=bool)], format="csr")
        idx = np.where((idx < 0) | (idx >= mat.shape[0] - 1),
                       mat.shape[0] - 1, idx)
    return _check(mat[idx])


def _group_union(mat, out_idx_per_row, out_rows, n_in):
    """out[g] = OR of mat rows mapped to g (reductions/contractions)."""
    coo = mat.tocoo()
    if coo.nnz == 0:
        return sps.csr_matrix((out_rows, n_in), dtype=bool)
    rows = np.asarray(out_idx_per_row, np.int64)[coo.row]
    # int64 ones: the constructor SUMS duplicates — a bool/int8 build
    # could wrap to zero on high-multiplicity entries
    out = sps.csr_matrix(
        (np.ones(coo.nnz, np.int64), (rows, coo.col)),
        shape=(out_rows, n_in))
    return _check((out > 0).astype(bool))


def _broadcast_rows(shape, mat, out_shape, n_in):
    """Broadcast a value's rows to out_shape (numpy semantics)."""
    if tuple(shape) == tuple(out_shape):
        return mat
    src = np.arange(_numel(shape), dtype=np.int64).reshape(shape)
    src = np.broadcast_to(src, out_shape)
    return _rows_take(mat, src, n_in)


def _dot_const_exact(cval, cshp, oshp, omat, cc, oc, cb, ob,
                     out_shape, n_in, const_is_lhs):
    """Exact contraction deps when one operand is a known constant:
    out(batch, i, j) depends on other(batch, k, j) exactly where
    const(batch, i, k) != 0.  Returns None when the selection would
    exceed the nnz cap (the caller falls back to the conservative
    union)."""
    if len(cshp) == 0:
        return None
    free_c = tuple(d for d in range(len(cshp)) if d not in cc + cb)
    free_o = tuple(d for d in range(len(oshp)) if d not in oc + ob)
    n_fc = _numel(tuple(cshp[d] for d in free_c))
    n_fo = _numel(tuple(oshp[d] for d in free_o))
    nz = np.nonzero(np.asarray(cval))
    nnz_c = len(nz[0])
    if nnz_c * max(n_fo, 1) > _NNZ_CAP:
        return None
    if nnz_c == 0:
        return _empty_mat(out_shape, n_in)
    strides_o = np.ones(max(len(oshp), 1), np.int64)
    for d in range(len(oshp) - 2, -1, -1):
        strides_o[d] = strides_o[d + 1] * oshp[d + 1]

    def lin(dims):
        if not dims:
            return np.zeros(nnz_c, np.int64)
        sizes = tuple(cshp[d] for d in dims)
        return np.ravel_multi_index(tuple(nz[d] for d in dims), sizes)

    B_lin = lin(cb)
    Ic_lin = lin(free_c)
    col_base = np.zeros(nnz_c, np.int64)
    for t, d in enumerate(cb):
        col_base += np.asarray(nz[d], np.int64) * strides_o[ob[t]]
    for t, d in enumerate(cc):
        col_base += np.asarray(nz[d], np.int64) * strides_o[oc[t]]
    if free_o:
        jgrid = np.unravel_index(np.arange(n_fo),
                                 tuple(oshp[d] for d in free_o))
        col_off = np.zeros(n_fo, np.int64)
        for t, d in enumerate(free_o):
            col_off += np.asarray(jgrid[t], np.int64) * strides_o[d]
    else:
        col_off = np.zeros(1, np.int64)
        n_fo = 1
    if const_is_lhs:
        row_base = (B_lin * n_fc + Ic_lin) * n_fo
        row_off = np.arange(n_fo, dtype=np.int64)
    else:
        row_base = B_lin * n_fo * n_fc + Ic_lin
        row_off = np.arange(n_fo, dtype=np.int64) * n_fc
    rows = (row_base[:, None] + row_off[None, :]).ravel()
    cols = (col_base[:, None] + col_off[None, :]).ravel()
    R = sps.csr_matrix(
        (np.ones(len(rows), np.int64), (rows, cols)),
        shape=(_numel(out_shape), omat.shape[0]))
    return _check(((R @ omat.astype(np.int64)) > 0).astype(bool))


def _contract(lhs, rhs, dims, out_shape, n_in):
    """dot_general's dependency rule (``lhs``/``rhs``: (shape, mat,
    value)): exact against a constant operand, else the union over the
    contracted axes."""
    (lc, rc, lb, rb) = dims
    (ashp, amat, av), (bshp, bmat, bv) = lhs, rhs
    exact = None
    if av is not None and amat.nnz == 0 and bmat.nnz:
        exact = _dot_const_exact(av, ashp, bshp, bmat, lc, rc, lb, rb,
                                 out_shape, n_in, const_is_lhs=True)
    elif bv is not None and bmat.nnz == 0 and amat.nnz:
        exact = _dot_const_exact(bv, bshp, ashp, amat, rc, lc, rb, lb,
                                 out_shape, n_in, const_is_lhs=False)
    if exact is not None:
        return exact

    def reduce(xshp, xmat, cdims, bdims):
        keep = tuple(d for d in range(len(xshp)) if d not in cdims)
        kshape = tuple(xshp[d] for d in keep)
        kidx = np.arange(_numel(kshape), dtype=np.int64).reshape(
            tuple(xshp[d] if d in keep else 1 for d in range(len(xshp))))
        grp = np.broadcast_to(kidx, xshp).ravel()
        red = _group_union(xmat, grp, _numel(kshape), n_in)
        # batch dims first (in bdims order), then the free dims
        order = tuple(bdims) + tuple(d for d in keep if d not in bdims)
        pos = [keep.index(d) for d in order]
        idx = np.transpose(np.arange(_numel(kshape), dtype=np.int64)
                           .reshape(kshape), pos)
        return tuple(kshape[p] for p in pos), _rows_take(red, idx, n_in)

    a_s, a_red = reduce(ashp, amat, lc, lb)
    b_s, b_red = reduce(bshp, bmat, rc, rb)
    nb = len(lb)
    ra, rbs = a_s[nb:], b_s[nb:]
    batch = a_s[:nb]
    a_idx = np.arange(_numel(a_s), dtype=np.int64).reshape(
        batch + ra + (1,) * len(rbs))
    b_idx = np.arange(_numel(b_s), dtype=np.int64).reshape(
        batch + (1,) * len(ra) + rbs)
    a_e = _rows_take(a_red, np.broadcast_to(a_idx, out_shape), n_in)
    b_e = _rows_take(b_red, np.broadcast_to(b_idx, out_shape), n_in)
    return _check(a_e.maximum(b_e))


def _is_index(dtype) -> bool:
    return dtype is not None and not (dtype.is_floating_point
                                      or dtype.is_complex)


def _eval_sparsity_graph(graph: _graph.Graph, n_in: int):
    """Interpret ``graph`` propagating per-element sparse dependency
    matrices.  Each env value is ``(shape, csr(numel, n_in), constant
    value or None)`` (a tuple of them for several outputs)."""
    env = {}
    for name, c in graph.consts.items():
        if isinstance(c, torch.Tensor):
            env[name] = (tuple(c.shape), _empty_mat(c.shape, n_in),
                         c.numpy() if not c.is_complex() else None)
        elif isinstance(c, (tuple, list)):
            env[name] = tuple((tuple(t.shape), _empty_mat(t.shape, n_in),
                               t.numpy()) for t in c)
    (name,) = graph.inputs
    env[name] = ((n_in,), sps.identity(n_in, dtype=bool, format="csr"),
                 None)

    def read(a):
        if isinstance(a, Ref):
            return env[a.name]
        return None

    for node in graph.nodes:
        env[node.name] = _node_rule(node, env, read, n_in, graph.meta)
    outs = []
    for o in graph.outputs:
        if isinstance(o, Ref):
            outs.append(env[o.name])
        else:
            raise UnsupportedPrimitive("a constant output")
    return outs


def _node_rule(node, env, read, n_in, meta):
    name = node.opname
    if name == "getitem":
        return env[node.args[0].name][node.args[1]]
    refs = _graph._refs((node.args, node.kwargs))
    ins = [env[r.name] for r in refs]
    shp = node.shape

    if torch.Tag.pointwise in node.op.tags or name in _IDENTITY:
        out = None
        for xs, xm, _xv in ins:
            xm = _broadcast_rows(xs, xm, shp, n_in)
            out = xm if out is None else _check(out.maximum(xm))
        return (shp, out if out is not None else _empty_mat(shp, n_in),
                None)

    if name == "copy":               # copy(self, src): src into self's shape
        b = node.bound()
        ss, sm, _ = read(b["src"])
        return (shp, _broadcast_rows(ss, sm, shp, n_in), None)

    if name in _REDUCTIONS:
        b = node.bound()
        xs, xm, _ = read(b["self"])
        dim = b.get("dim")
        dims = (tuple(range(len(xs))) if dim is None or dim == []
                else tuple(d % len(xs) for d in (
                    dim if isinstance(dim, (list, tuple)) else [dim])))
        out_keep = tuple(1 if d in dims else s for d, s in enumerate(xs))
        grp = np.broadcast_to(np.arange(_numel(out_keep), dtype=np.int64)
                              .reshape(out_keep), xs).ravel()
        mat = _group_union(xm, grp, _numel(out_keep), n_in)
        if isinstance(shp, tuple) and shp and isinstance(shp[0], tuple):
            return tuple((s, mat, None) for s in shp)
        return (shp, mat, None)

    if name in _CUMULATIVE:
        b = node.bound()
        xs, xm, _ = read(b["self"])
        ax = b["dim"] % len(xs)
        k = xs[ax]
        if _numel(xs) * (k + 1) // 2 > _NNZ_CAP:
            raise UnsupportedPrimitive("cumulative (axis too large)")
        base = np.arange(_numel(xs), dtype=np.int64).reshape(xs)
        pos = np.arange(k)
        out = None
        for j in range(k):
            m = _rows_take(xm, np.take(base, np.minimum(pos, j), axis=ax),
                           n_in)
            out = m if out is None else _check(out.maximum(m))
        res = (tuple(xs), out, None)
        return (res, res) if name in ("cummax", "cummin") else res

    if name in _CONTRACTIONS or name in ("addmm", "addmv", "baddbmm"):
        b = node.bound()
        base = {"addmm": "mm", "addmv": "mv", "baddbmm": "bmm"}.get(name,
                                                                    name)
        keys = {"mm": ("self", "mat2"), "mv": ("self", "vec"),
                "dot": ("self", "tensor"), "bmm": ("self", "mat2")}[base]
        if base != name:
            keys = {"addmm": ("mat1", "mat2"), "addmv": ("mat", "vec"),
                    "baddbmm": ("batch1", "batch2")}[name]
        mat = _contract(read(b[keys[0]]), read(b[keys[1]]),
                        _CONTRACTIONS[base], shp, n_in)
        if base != name:
            bs, bm, _ = read(b["self"])
            mat = _check(mat.maximum(_broadcast_rows(bs, bm, shp, n_in)))
        return (shp, mat, None)

    if name in _SCATTERS:
        return _scatter(node, read, n_in)

    if name in _STRUCTURAL:
        return _structural(node, env, n_in, meta)

    raise UnsupportedPrimitive(str(node.op))


def _data_and_ids(node, env, meta):
    """The node's arguments with each floating (data) operand replaced by
    an int64 id array (offset past the operands before it), the
    operands' matrices, and the index operands checked constant."""
    mats = []
    offset = [0]

    def sub(a):
        if not isinstance(a, Ref):
            return a
        val = env[a.name]
        shape = val[0]
        if _is_index(meta[a.name][1]):
            if val[1].nnz or val[2] is None:
                raise UnsupportedPrimitive(f"{node.opname} (traced indices)")
            return torch.as_tensor(val[2])
        ids = torch.arange(offset[0], offset[0] + _numel(shape),
                           dtype=torch.int64).reshape(shape)
        offset[0] += _numel(shape)
        mats.append(val[1])
        return ids

    args = _graph._map_args(node.args, sub)
    kwargs = _graph._map_args(node.kwargs, sub)
    return args, kwargs, mats


def _structural(node, env, n_in, meta):
    """A row selection: run the op on id arrays (padding fills −1)."""
    args, kwargs, mats = _data_and_ids(node, env, meta)
    if node.opname == "constant_pad_nd":
        args = tuple(args[:2]) + (-1,)
        kwargs = {k: v for k, v in kwargs.items() if k != "value"}
    out = _graph.run_op(node, args, kwargs)
    stacked = (mats[0] if len(mats) == 1
               else sps.vstack(mats, format="csr"))
    if isinstance(out, (tuple, list)):
        return tuple((tuple(o.shape), _rows_take(stacked, o.numpy(), n_in),
                      None) for o in out)
    return (tuple(out.shape), _rows_take(stacked, out.numpy(), n_in), None)


def _scatter(node, read, n_in):
    """A scatter with constant indices, as the JAX package's rule: the
    update ids placed by the replace op on a −1 operand, and a count
    pass; the result unions the operand's dependencies with the placed
    updates' (a replacing scatter keeps the operand's too: a safe
    superset), and colliding accumulated updates union every update's
    dependencies into each touched row."""
    b = node.bound()
    name = node.opname
    xs, xm, _ = read(b["self"])
    upd_key = {"index_put": "values", "_index_put_impl": "values",
               "index_add": "source", "index_copy": "source"}.get(name, "src")
    if upd_key not in b or not isinstance(b[upd_key], Ref):
        raise UnsupportedPrimitive(f"{name} (a scalar update)")
    us, um, _ = read(b[upd_key])

    def const(a):
        if isinstance(a, Ref):
            v = read(a)
            if v[1].nnz or v[2] is None:
                raise UnsupportedPrimitive(f"{name} (traced indices)")
            return torch.as_tensor(v[2])
        return a

    upd_ids = torch.arange(_numel(us), dtype=torch.int64).reshape(us)
    neg = torch.full(xs, -1, dtype=torch.int64)
    zeros = torch.zeros(xs, dtype=torch.int64)
    ones = torch.ones(us, dtype=torch.int64)
    a = torch.ops.aten
    if name in ("index_put", "_index_put_impl"):
        idx = [None if i is None else const(i) for i in b["indices"]]
        accumulate = bool(b.get("accumulate"))
        placed = a.index_put.default(neg, idx, upd_ids, False)
        counts = a.index_put.default(zeros, idx, ones, True)
    elif name in ("index_add", "index_copy"):
        idx = const(b["index"])
        accumulate = name == "index_add"
        placed = a.index_copy.default(neg, b["dim"], idx, upd_ids)
        counts = a.index_add.default(zeros, b["dim"], idx, ones)
    else:
        idx = const(b["index"])
        accumulate = name != "scatter" or b.get("reduce") is not None
        placed = a.scatter.src(neg, b["dim"], idx, upd_ids)
        counts = a.scatter_add.default(zeros, b["dim"], idx, ones)
    placed = placed.numpy()
    dup = counts.numel() > 0 and int(counts.max()) > 1
    if dup and accumulate:
        touched = np.flatnonzero(placed.ravel() >= 0)
        u_any = um.max(axis=0).tocoo()
        add = sps.csr_matrix(
            (np.ones(len(touched) * u_any.nnz, bool),
             (np.repeat(touched, u_any.nnz), np.tile(u_any.col,
                                                    len(touched)))),
            shape=(xm.shape[0], n_in))
        return (tuple(xs), _check(xm.maximum(add)), None)
    return (tuple(xs), _check(xm.maximum(_rows_take(um, placed, n_in))),
            None)


def detect_sparsity_exact(f_flat, n_in: int, dtype=torch.float64,
                          max_n: int = 16_777_216, *,
                          device=None) -> Optional["CSR"]:
    """Exact Jacobian sparsity of ``f_flat(u_vec) -> resid_vec`` by
    interpreting its ATen graph (traced on ``device``, the card when
    None), or None if the trace fails or uses unsupported ops, ``n_in >
    max_n``, or the dependency pattern explodes past the nnz cap.  The
    cost scales with the pattern's nnz, not n²."""
    from .. import _backend
    from .sparse import CSR

    if n_in > max_n:
        return None
    dev = _backend.resolve_device(device)
    dt = _backend.resolve_dtype(dtype)
    try:
        graph = _graph.trace(f_flat, torch.zeros((n_in,), dtype=dt,
                                                 device=dev))
        outs = _eval_sparsity_graph(graph, n_in)
    except (UnsupportedPrimitive, _graph.GraphTraceError):
        return None
    except Exception:  # noqa: BLE001 — any interpretation failure → probe
        return None
    _shp, dep, _val = outs[0]
    dep = dep.tocoo()
    return CSR.from_pattern(np.asarray(dep.row, np.int64),
                            np.asarray(dep.col, np.int64),
                            (dep.shape[0], n_in))

"""Automatic double-f32 evaluation of arbitrary residuals (the port of
``ops/doublef32_eval.py``).

``df_eval(fn, DF(u_hi, u_lo), ...)`` traces ``fn`` to its ATen graph once
(``ops/_graph.py``, the front end the exact sparsity tracer reads too) and
re-evaluates it with every float carried as a double-word (hi, lo) pair
(``ops/doublef32.py``), so a polynomial or rational residual gets the
~48-bit defect the mixed-precision refinement loop needs
(``solvers/refinement.py``) without a hand-written double-word variant.

Coverage: arithmetic (add/sub/mul/div/neg, ``pow`` with an integer
exponent by square-and-multiply, abs/maximum/minimum), the exact data
movement (views, permutes, slices, roll, flip, cat/stack, pad, index
and gather, the replace scatters — both words move identically), the
compensated sum and mean along axes, ``sqrt`` (Newton-corrected),
comparisons and ``where`` on the double-word value, a single unbatched
contraction (``mm`` / ``mv`` / ``dot``: error-free products and a
compensated fold, with an expansion guard), and the genuine double-word
transcendentals exp/log/sin/cos/tan/expm1/log1p and float ``pow``
(x > 0).  ``tanh``, ``sinh`` and the other transcendentals raise
``NotImplementedError`` with guidance: opt into :func:`first_order_rules`,
register a rule with :func:`register_df_rule` (keyed by an ATen overload
such as ``torch.ops.aten.tanh.default`` or its packet
``torch.ops.aten.tanh``), or write that term with the doublef32 ops.

Python scalars in the graph are Python floats, exact in f64, and split
into exact double-words.  Tensor constants (closed-over tensors, values
built with ``dtype=u.dtype``) are rounded to the working dtype when the
graph is traced in f32; ``trace_wide`` retraces in f64 and keeps that
graph when it matches (see :func:`df_eval`).  Non-float values (ints,
bools, index arrays) pass through untouched.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict

import numpy as np
import torch

from . import _graph
from ._graph import Ref
from .doublef32 import (DF, _fold, df_add, df_cos, df_div, df_exp, df_expm1,
                        df_log, df_log1p, df_mul, df_sin, df_sub,
                        fast_two_sum, two_prod)

aten = torch.ops.aten


class _Ctx:
    """The evaluation's working dtype and device: a wider float value
    (a wide graph's f64, a Python float) is split into an exact DF of
    it."""

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, device


_CTX: list = [None]


def _val(x):
    """Collapse to a plain value (the best single-word value)."""
    if isinstance(x, DF):
        return x.hi + x.lo
    return x


def _split(v) -> DF:
    """An exact double-word of the working dtype from a wider float value
    (a Python float, an f64 tensor)."""
    ctx = _CTX[0]
    v64 = torch.as_tensor(v, dtype=torch.float64, device=ctx.device)
    hi = v64.to(ctx.dtype)
    return DF(hi, (v64 - hi.to(torch.float64)).to(ctx.dtype))


def _as_df(x):
    """A DF from a DF, a float tensor or a Python number (exact); other
    values ride as they are."""
    if isinstance(x, DF):
        return x
    ctx = _CTX[0]
    if isinstance(x, (float, int)) and not isinstance(x, bool):
        return _split(float(x))
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        if x.dtype.itemsize > ctx.dtype.itemsize:
            return _split(x)
        return DF(x, torch.zeros_like(x))
    return x


_DF_RULES: Dict = {}


def register_df_rule(op, rule: Callable):
    """``rule(node, *args, **kwargs) -> output`` (a DF or a plain value)
    for an ATen overload (``torch.ops.aten.exp.default``) or a whole
    packet (``torch.ops.aten.exp``).  ``args`` are DF for float values,
    plain values otherwise."""
    _DF_RULES[op] = rule


def _lookup(rules, op):
    if rules is None:
        return None
    if op in rules:
        return rules[op]
    packet = getattr(op, "overloadpacket", None)
    return rules.get(packet)


def _df_sum_along(x: DF, axes) -> DF:
    """Compensated sum over ``axes``: move the reduced axes last, then
    fold halves pairwise with df_add (log₂ k vectorized levels)."""
    nd = x.hi.dim()
    axes = tuple(a % nd for a in axes)
    keep = tuple(a for a in range(nd) if a not in axes)
    hi = x.hi.permute(keep + axes)
    lo = x.lo.permute(keep + axes)
    kshape = tuple(hi.shape[:len(keep)])
    return _fold(hi.reshape(kshape + (-1,)), lo.reshape(kshape + (-1,)))


def _df_sqrt(x: DF) -> DF:
    """Double-word sqrt: s = fl(sqrt(hi)); one Newton correction with
    error-free products, e = (x − s²)/(2s); 0 at an exact zero."""
    s = torch.sqrt(x.hi)
    s2, s2e = two_prod(s, s)
    r = df_sub(x, DF(s2, s2e))
    e = torch.where(s > 0, (r.hi + r.lo) / (2.0 * s), torch.zeros_like(s))
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def _integer_pow(x: DF, y: int) -> DF:
    if y == 0:
        return DF(torch.ones_like(x.hi), torch.zeros_like(x.hi))
    if y < 0:
        one = DF(torch.ones_like(x.hi), torch.zeros_like(x.hi))
        return df_div(one, _integer_pow(x, -y))
    result = None
    base = x
    n = y
    while n:
        if n & 1:
            result = base if result is None else df_mul(result, base)
        n >>= 1
        if n:
            base = df_mul(base, base)
    return result


def _select(cond, a, b) -> DF:
    """where(cond, a, b) on both words."""
    a, b = _as_df(a), _as_df(b)
    return DF(torch.where(cond, a.hi, b.hi), torch.where(cond, a.lo, b.lo))


def _df_pow(node, a, b):
    """exp(y·log x) where x > 0; elsewhere plain ``pow`` (0**1.5 is 0, not
    NaN through log 0), as the JAX package's rule does."""
    xa, xb = _as_df(a), _as_df(b)
    if not isinstance(xa, DF):
        xa = _as_df(torch.as_tensor(xa, dtype=xb.hi.dtype,
                                    device=xb.hi.device))
    pos = xa.hi > 0
    safe = DF(torch.where(pos, xa.hi, torch.ones_like(xa.hi)),
              torch.where(pos, xa.lo, torch.zeros_like(xa.lo)))
    r = df_exp(df_mul(xb, df_log(safe)))
    plain = torch.pow(xa.hi, xb.hi)
    return DF(torch.where(pos, r.hi, plain),
              torch.where(pos, r.lo, torch.zeros_like(r.lo)))


def _pow_tensor_scalar(node, a, y):
    if isinstance(y, int) and not isinstance(y, bool):
        return _integer_pow(_as_df(a), y)
    return _df_pow(node, a, y)


def _scaled(b, alpha):
    return b if alpha == 1 else df_mul(_as_df(b), _as_df(alpha))


def _reduce_dims(x, dim):
    nd = x.hi.dim()
    if dim is None or dim == [] or dim == ():
        return tuple(range(nd))
    return tuple(d % nd for d in (dim if isinstance(dim, (list, tuple))
                                  else [dim]))


def _sum_rule(node, x, dim=None, keepdim=False, *, dtype=None):
    x = _as_df(x)
    dims = _reduce_dims(x, dim)
    out = _df_sum_along(x, dims)
    if keepdim:
        shape = tuple(1 if d in dims else s for d, s in
                      enumerate(x.hi.shape))
        out = DF(out.hi.reshape(shape), out.lo.reshape(shape))
    return out


def _mean_rule(node, x, dim=None, keepdim=False, *, dtype=None):
    x = _as_df(x)
    dims = _reduce_dims(x, dim)
    count = int(np.prod([x.hi.shape[d] for d in dims], dtype=np.int64))
    return df_div(_sum_rule(node, x, dim, keepdim), _as_df(count))


def _plain_on_value(node, *args, **kwargs):
    """Comparisons, sign, isfinite, extremes: the op on the collapsed
    double-word values."""
    return node.op(*[_val(a) for a in args],
                   **{k: _val(v) for k, v in kwargs.items()})


def _movement(node, *args, **kwargs):
    """Exact data movement: the op on each word (every float operand
    as a DF)."""
    if not any(isinstance(a, DF) for a in _flat(args)):
        return node.op(*args, **kwargs)

    def word(i):
        def pick(a):
            if isinstance(a, DF):
                return a[i]
            if isinstance(a, torch.Tensor) and a.is_floating_point():
                return a if i == 0 else torch.zeros_like(a)
            return a
        return _graph._map_args(args, pick)
    hi = node.op(*word(0), **kwargs)
    lo = node.op(*word(1), **kwargs)
    if isinstance(hi, (tuple, list)):
        return [DF(h, l) for h, l in zip(hi, lo)]
    return DF(hi, lo)


def _flat(x):
    out = []
    _graph._map_args(x, out.append)
    return out


def _pad_rule(node, x, pad, value=None):
    x = _as_df(x)
    v = _as_df(0.0 if value is None else value)
    return DF(aten.constant_pad_nd.default(x.hi, pad, float(v.hi)),
              aten.constant_pad_nd.default(x.lo, pad, float(v.lo)))


def _convert_rule(node, x, *args, **kwargs):
    """``_to_copy`` / a dtype change: the identity on a float DF at the
    working grade (a wide trace's f64 casts included); a cast to an
    integer or bool collapses first."""
    dtype = kwargs.get("dtype")
    if dtype is None or dtype.is_floating_point:
        return _as_df(x)
    return _val(x).to(dtype)


def _dot_general_rule(node, a, b):
    """Double-word mm / mv / dot by FULL expansion: elementwise error-free
    products, then a compensated pairwise fold over the contraction axis
    (genuinely ~48-bit).  Cost O(m·n·k) DF intermediates: refused past
    50,000,000 products."""
    a, b = _as_df(a), _as_df(b)
    ahi, alo, bhi, blo = a.hi, a.lo, b.hi, b.lo
    k = ahi.shape[-1]
    if ahi.numel() // max(k, 1) * bhi.numel() > 50_000_000:
        raise NotImplementedError(
            "df_eval: a contraction's expansion would materialize "
            f"{ahi.numel() // max(k, 1) * bhi.numel()} DF products; "
            "hand-write this term with ops.doublef32 primitives")
    a_shape = tuple(ahi.shape[:-1])
    b_rest = tuple(bhi.shape[1:])
    shape = a_shape + (k,) + b_rest
    ah = ahi.reshape(a_shape + (k,) + (1,) * len(b_rest)).expand(shape)
    al = alo.reshape(a_shape + (k,) + (1,) * len(b_rest)).expand(shape)
    bh = bhi.reshape((1,) * len(a_shape) + (k,) + b_rest).expand(shape)
    bl = blo.reshape((1,) * len(a_shape) + (k,) + b_rest).expand(shape)
    prod = df_mul(DF(ah, al), DF(bh, bl))
    return _df_sum_along(prod, (len(a_shape),))


def _tan(node, a):
    a = _as_df(a)
    return df_div(df_sin(a), df_cos(a))


def _init_rules():
    R = _DF_RULES
    R[aten.add] = lambda n, a, b, alpha=1: df_add(_as_df(a),
                                                  _as_df(_scaled(b, alpha)))
    R[aten.sub] = lambda n, a, b, alpha=1: df_sub(_as_df(a),
                                                  _as_df(_scaled(b, alpha)))
    R[aten.rsub] = lambda n, a, b, alpha=1: df_sub(_as_df(b),
                                                   _as_df(_scaled(a, alpha)))
    R[aten.mul] = lambda n, a, b: df_mul(_as_df(a), _as_df(b))
    R[aten.div.Tensor] = lambda n, a, b: df_div(_as_df(a), _as_df(b))
    R[aten.div.Scalar] = lambda n, a, b: df_div(_as_df(a), _as_df(b))
    R[aten.neg] = lambda n, a: DF(-a.hi, -a.lo) if isinstance(a, DF) else -a
    R[aten.pow.Tensor_Scalar] = _pow_tensor_scalar
    R[aten.pow.Tensor_Tensor] = _df_pow
    R[aten.pow.Scalar] = _df_pow
    R[aten.sqrt] = lambda n, a: _df_sqrt(_as_df(a))
    R[aten.exp] = lambda n, a: df_exp(_as_df(a))
    R[aten.log] = lambda n, a: df_log(_as_df(a))
    R[aten.sin] = lambda n, a: df_sin(_as_df(a))
    R[aten.cos] = lambda n, a: df_cos(_as_df(a))
    R[aten.tan] = _tan
    R[aten.expm1] = lambda n, a: df_expm1(_as_df(a))
    R[aten.log1p] = lambda n, a: df_log1p(_as_df(a))
    R[aten.abs] = lambda n, a: _select(_val(a) < 0, DF(-_as_df(a).hi,
                                                       -_as_df(a).lo), a)
    R[aten.maximum] = lambda n, a, b: _select(_val(a) < _val(b), b, a)
    R[aten.minimum] = lambda n, a, b: _select(_val(b) < _val(a), b, a)
    R[aten.where.self] = lambda n, c, a, b: _select(_val(c), a, b)
    for op in (aten.eq, aten.ne, aten.lt, aten.le, aten.gt, aten.ge,
               aten.sign, aten.isfinite, aten.isnan, aten.amax, aten.amin,
               aten.max, aten.min,
               aten.logical_and, aten.logical_or, aten.logical_not):
        R[op] = _plain_on_value
    R[aten.sum] = _sum_rule
    R[aten.mean] = _mean_rule
    for op in (aten.view, aten._unsafe_view, aten.reshape, aten.permute,
               aten.t, aten.transpose, aten.select, aten.slice,
               aten.unsqueeze, aten.squeeze, aten.expand, aten.roll,
               aten.flip, aten.index, aten.index_select, aten.gather,
               aten.narrow, aten.repeat, aten.diagonal, aten.split,
               aten.split_with_sizes, aten.unbind, aten.clone, aten.alias,
               aten.detach, aten.lift_fresh_copy, aten.cat, aten.stack,
               aten.slice_scatter, aten.select_scatter, aten.index_copy,
               aten.scatter.src, aten.copy):
        R[op] = _movement
    R[aten.index_put] = (lambda n, x, idx, v, accumulate=False:
                         _movement(n, x, idx, v) if not accumulate
                         else _no_rule(n))
    R[aten.constant_pad_nd] = _pad_rule
    R[aten._to_copy] = _convert_rule
    R[aten.mm] = _dot_general_rule
    R[aten.mv] = _dot_general_rule
    R[aten.dot] = _dot_general_rule


def _no_rule(node):
    raise NotImplementedError(
        f"df_eval: no double-f32 rule for the op '{node.op}'. "
        f"Polynomial/rational residuals are fully covered; for other "
        f"transcendentals, accumulating scatters or batched contractions "
        f"either register a rule (ops.doublef32_eval.register_df_rule) "
        f"or write that term with the ops.doublef32 primitives.")


_init_rules()


def first_order_rules() -> Dict:
    """Optional rule overlay for transcendentals with FIRST-ORDER lo
    propagation: ``hi = f(x.hi), lo = f'(x.hi)·x.lo``.

    The transcendental TERM is then only f32-accurate, while the rest of
    the residual keeps double-word accuracy: right when the f32 stall
    comes from scaling or cancellation elsewhere.  Pass as
    ``df_eval(fn, ..., rules=first_order_rules())`` or
    ``auto_refine(..., first_order_transcendentals=True)``."""

    def mk(f, dfdx):
        def rule(node, x):
            x = _as_df(x)
            h = f(x.hi)
            return DF(h, dfdx(x.hi, h) * x.lo)
        return rule

    return {
        aten.exp: mk(torch.exp, lambda x, h: h),
        aten.log: mk(torch.log, lambda x, h: 1.0 / x),
        aten.sin: mk(torch.sin, lambda x, h: torch.cos(x)),
        aten.cos: mk(torch.cos, lambda x, h: -torch.sin(x)),
        aten.tan: mk(torch.tan, lambda x, h: 1.0 + h * h),
        aten.tanh: mk(torch.tanh, lambda x, h: 1.0 - h * h),
        aten.sinh: mk(torch.sinh, lambda x, h: torch.cosh(x)),
        aten.cosh: mk(torch.cosh, lambda x, h: torch.sinh(x)),
        aten.exp2: mk(torch.exp2, lambda x, h: h * np.log(2.0)),
        aten.expm1: mk(torch.expm1, lambda x, h: h + 1.0),
        aten.log1p: mk(torch.log1p, lambda x, h: 1.0 / (1.0 + x)),
        aten.rsqrt: mk(torch.rsqrt, lambda x, h: -0.5 * h / x),
        aten.sigmoid: mk(torch.sigmoid, lambda x, h: h * (1.0 - h)),
    }


def _device_consts(graph: _graph.Graph) -> dict:
    """The graph's constants on the evaluation's device, float tensors
    split into double-words."""
    ctx = _CTX[0]
    out = {}
    for name, c in graph.consts.items():
        if isinstance(c, torch.Tensor):
            c = c.to(ctx.device)
            out[name] = _as_df(c) if c.is_floating_point() else c
        else:
            out[name] = c
    return out


def _eval_graph_df(graph: _graph.Graph, consts: dict, args, rules=None):
    env: dict = dict(consts)
    ctx = _CTX[0]
    for name, a in zip(graph.inputs, args):
        env[name] = a

    def resolve(x):
        return env[x.name] if isinstance(x, Ref) else x

    for node in graph.nodes:
        a = _graph._map_args(node.args, resolve)
        kw = _graph._map_args(node.kwargs, resolve)
        if node.opname == "getitem":
            env[node.name] = a[0][a[1]]
            continue
        kw = {k: (ctx.device if isinstance(v, torch.device) else v)
              for k, v in kw.items()}
        if not any(isinstance(v, DF) for v in _flat((a, kw))):
            out = node.op(*a, **kw)     # integer / bool index pipelines
            env[node.name] = (_as_df(out) if isinstance(out, torch.Tensor)
                              and out.is_floating_point() else out)
            continue
        rule = _lookup(rules, node.op) or _lookup(_DF_RULES, node.op)
        if rule is None:
            _no_rule(node)
        env[node.name] = rule(node, *a, **kw)
    return [resolve(o) for o in graph.outputs]


def _consistent(narrow: _graph.Graph, wide: _graph.Graph) -> bool:
    """True when the f32 and f64 traces describe the SAME function: the
    same op sequence (dtype conversions aside) and every float constant
    and scalar agreeing to f32 rounding (~100 ulp headroom).  A residual
    that introspects its dtype (``torch.finfo(u.dtype).eps`` in a tensor)
    fails."""
    drop = {"_to_copy"}
    if ([n for n in narrow.opnames() if n not in drop]
            != [n for n in wide.opnames() if n not in drop]):
        return False

    def floats(g):
        vals = [c for c in g.consts.values() if isinstance(c, torch.Tensor)
                and c.is_floating_point()]
        for n in g.nodes:
            if n.opname in drop:
                continue
            vals += [np.float64(v) for v in _flat((n.args, n.kwargs))
                     if isinstance(v, float)]
        return vals

    fn, fw = floats(narrow), floats(wide)
    if len(fn) != len(fw):
        return False
    for a, b in zip(fn, fw):
        a = np.asarray(a.double() if isinstance(a, torch.Tensor) else a)
        b = np.asarray(b.double() if isinstance(b, torch.Tensor) else b)
        if a.shape != b.shape or not np.allclose(
                a, b, rtol=2e-5, atol=1e-37, equal_nan=True):
            return False
    return True


def _flatten_args(x, leaves):
    """Flatten ``x`` with DF pairs as leaves; returns a rebuild function."""
    if isinstance(x, DF) or not isinstance(x, (tuple, list, dict)):
        leaves.append(x)
        return lambda it: next(it)
    if isinstance(x, dict):
        keys = sorted(x)
        subs = [_flatten_args(x[k], leaves) for k in keys]
        return lambda it: {k: s(it) for k, s in zip(keys, subs)}
    subs = [_flatten_args(v, leaves) for v in x]
    return lambda it: type(x)(s(it) for s in subs)


class DFGraph:
    """A residual traced once for double-f32 evaluation (see
    :func:`df_trace`).  Calling it evaluates the graph on arguments of the
    examples' structure, shapes and dtypes: ``graph(*args, rules=None)``
    returns what :func:`df_eval` would, with no second trace."""

    def __init__(self, graph: _graph.Graph, out_spec, work, device):
        self.graph, self.out_spec = graph, out_spec
        self.work, self.device = work, device
        self._consts = None

    def __call__(self, *args, rules: Dict = None):
        from ..utils.pytree import tree_unflatten
        leaves: list = []
        for a in args:
            _flatten_args(a, leaves)
        dfs = [a if isinstance(a, DF) else _as_df_plain(a) for a in leaves]
        prev = _CTX[0]
        _CTX[0] = _Ctx(self.work, self.device)
        try:
            if self._consts is None:
                self._consts = _device_consts(self.graph)
            outs = _eval_graph_df(self.graph, self._consts, dfs, rules=rules)
            outs = [_as_df(o) if isinstance(o, torch.Tensor)
                    and o.is_floating_point() else o for o in outs]
        finally:
            _CTX[0] = prev
        return tree_unflatten(self.out_spec, outs)


def df_trace(fn: Callable, *args, trace_wide: bool = True) -> DFGraph:
    """Trace ``fn`` at ``args`` (as :func:`df_eval` takes them) once, for
    evaluations at other values of the same structure, shapes and dtypes.

    ``trace_wide`` (default True, f32 inputs only): the graph is traced
    twice, with f32 and with float64 inputs, and the float64 graph is
    kept when both describe the same function (the same ops, every
    constant agreeing to f32 rounding): its tensor constants are then
    exact in f64 and split into exact double-words, where the f32 graph's
    are f32-rounded (a ``1/h²`` built as a tensor of ``u.dtype`` would cap
    the defect at ~1e-8 relative).  When they differ — a residual that
    introspects its dtype — a warning is emitted and the f32 graph is
    used; ``trace_wide=False`` uses it silently, as does a residual that
    cannot run at f64 (a product with a closed-over f32 matrix).
    """
    from ..utils.pytree import tree_flatten
    leaves: list = []
    rebuild = [_flatten_args(a, leaves) for a in args]
    his = [a.hi if isinstance(a, DF) else a for a in leaves]
    spec = []

    def flat_fn(*hargs):
        it = iter(hargs)
        out = fn(*[r(it) for r in rebuild])
        outs, s = tree_flatten(out)
        spec[:] = [s]
        return tuple(outs)

    work = next((h.dtype for h in his if isinstance(h, torch.Tensor)
                 and h.is_floating_point()), None)
    device = next((h.device for h in his if isinstance(h, torch.Tensor)),
                  torch.device("cpu"))
    graph = _graph.trace(flat_fn, *his)
    out_spec = spec[0]
    if trace_wide and work == torch.float32:
        wargs = [h.double() if isinstance(h, torch.Tensor)
                 and h.is_floating_point() else h for h in his]
        try:
            wgraph = _graph.trace(flat_fn, *wargs)
        except _graph.GraphTraceError:
            # e.g. a product with a closed-over f32 matrix, which torch
            # does not promote: that residual's constants are its f32
            # tensors, exact in the narrow graph
            wgraph = None
        if wgraph is not None and _consistent(graph, wgraph):
            graph = wgraph
        elif wgraph is not None:
            warnings.warn(
                "df_eval: the residual embeds different constants (or a "
                "different graph) under a float64 trace — it likely "
                "introspects its input dtype (e.g. torch.finfo(x.dtype)). "
                "Falling back to the narrow f32 trace; its tensor "
                "constants are f32-rounded (defect floor ~1e-8 relative). "
                "Pass trace_wide=False to silence.", stacklevel=3)
    return DFGraph(graph, out_spec, work or torch.float32, device)


def df_eval(fn: Callable, *args, rules: Dict = None,
            trace_wide: bool = True):
    """Evaluate ``fn(*values)`` in double-f32.

    Each argument is a ``DF`` pair, a plain tensor (exact, lo = 0), or a
    non-float leaf; pytrees (tuples, lists, dicts) of them are accepted.
    Returns the output with every float leaf as a ``DF`` pair.  ``rules``
    is an optional per-call rule overlay consulted before the built-in
    table (e.g. :func:`first_order_rules`).  ``trace_wide``: see
    :func:`df_trace`; a caller that evaluates one residual at many points
    traces it once with :func:`df_trace` and calls the result.
    """
    return df_trace(fn, *args, trace_wide=trace_wide)(*args, rules=rules)


def _as_df_plain(x):
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return DF(x, torch.zeros_like(x))
    return x

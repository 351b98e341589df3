"""The residual's ATen graph: the port's counterpart of ``jax.make_jaxpr``,
read by the exact sparsity tracer (``ops/sparsity_trace.py``) and the
double-f32 evaluator (``ops/doublef32_eval.py``).

``trace(fn, *examples)`` runs ``make_fx(torch.func.functionalize(fn))``
on the examples' device, so in-place writes (``index_put_``, slice
assignment) reach the interpreters as functional ops
(``index_put``, ``slice_scatter``, ``copy``).  The result lists the graph's
nodes in order, each with its ATen overload, its arguments (``Ref`` for a
value of the graph, Python values otherwise), and its shape and dtype.

Every value that does not depend on the inputs is a constant: the
``_tensor_constant`` attributes (closed-over tensors), values built by
factory ops (``arange``, ``full``, ``zeros``, ``linspace``), the
``*_like`` factories of an input (their value depends on its shape
only), and any op applied to constants.  The front end evaluates them once,
on the CPU, by running the op itself, and keeps them as CPU tensors in
``Graph.consts``; the interpreters never see those nodes.  Python scalars
stay Python numbers in the arguments: a float is exact in f64.

Any failure to trace (data-dependent control flow reads a value with
``aten._local_scalar_dense``; an op the tracer cannot run) raises
:class:`GraphTraceError`, the one exception both callers catch.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Callable

import torch


class GraphTraceError(Exception):
    """The residual could not be traced into an ATen graph."""


@dataclasses.dataclass(frozen=True)
class Ref:
    """A value of the graph, by node name."""

    name: str


@dataclasses.dataclass
class GNode:
    name: str
    op: Any            # an ATen OpOverload, or operator.getitem
    args: tuple
    kwargs: dict
    shape: Any         # a tuple, or a tuple of them for several outputs
    dtype: Any

    @property
    def opname(self) -> str:
        """The overload packet's name (``"add"`` for ``aten.add.Tensor``)."""
        if self.op is operator.getitem:
            return "getitem"
        return self.op.overloadpacket.__name__

    def bound(self) -> dict:
        """The arguments by the op's schema names (defaults filled)."""
        out = {}
        schema = self.op._schema
        for i, a in enumerate(schema.arguments):
            if i < len(self.args):
                out[a.name] = self.args[i]
            elif a.name in self.kwargs:
                out[a.name] = self.kwargs[a.name]
            elif a.has_default_value():
                out[a.name] = a.default_value
        return out


@dataclasses.dataclass
class Graph:
    inputs: list                  # input names, in the argument order
    nodes: list                   # the nodes that depend on the inputs
    outputs: list                 # Ref or Python value a flat output
    consts: dict                  # name -> CPU tensor (or a tuple of them)
    meta: dict                    # name -> (shape, dtype)

    def opnames(self) -> list:
        return [n.opname for n in self.nodes]


# factories of a tensor whose value depends on its shape and dtype only
_SHAPE_ONLY = {"zeros_like", "ones_like", "full_like", "empty_like",
               "new_zeros", "new_ones", "new_full", "new_empty"}


def _shape_dtype(val):
    if isinstance(val, (tuple, list)):
        return (tuple(_shape_dtype(v)[0] for v in val),
                tuple(_shape_dtype(v)[1] for v in val))
    if isinstance(val, torch.Tensor):
        return tuple(val.shape), val.dtype
    return (), None


def _map_args(x, fn):
    """``fn`` on every leaf of nested lists, tuples (not named ones: a
    DF pair is a leaf) and dicts; fx's immutable lists come back as
    plain lists."""
    if isinstance(x, list):
        return [_map_args(v, fn) for v in x]
    if isinstance(x, tuple) and not hasattr(x, "_fields"):
        return tuple(_map_args(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _map_args(v, fn) for k, v in x.items()}
    return fn(x)


def _refs(x) -> list:
    out = []
    _map_args(x, lambda v: out.append(v) if isinstance(v, Ref) else None)
    return out


def _on_cpu(x):
    if isinstance(x, torch.device):
        return torch.device("cpu")
    return x


def _out_of_place(op):
    """An in-place view op that functionalization leaves in the graph
    (``squeeze_``, ``t_``) as its out-of-place overload."""
    if op is operator.getitem or torch.Tag.inplace_view not in op.tags:
        return op
    packet = getattr(torch.ops.aten, op.overloadpacket.__name__[:-1])
    return getattr(packet, op._overloadname)


def run_op(node: GNode, args, kwargs):
    """Run the node's op on concrete values (on the CPU)."""
    if node.op is operator.getitem:
        return args[0][args[1]]
    return node.op(*args, **_map_args(kwargs, _on_cpu))


def trace(fn: Callable, *examples: torch.Tensor) -> Graph:
    """The ATen graph of ``fn(*examples)`` (see the module docstring)."""
    from torch.fx.experimental.proxy_tensor import make_fx
    try:
        # one eager call first: a residual that caches a tensor it builds
        # on its first call (a forcing mask, say) caches a real one, not
        # a tracing wrapper that would leak into later calls
        with torch.no_grad():
            fn(*examples)
        gm = make_fx(torch.func.functionalize(fn))(*examples)
    except Exception as e:  # noqa: BLE001 — any trace failure is one error
        raise GraphTraceError(f"{type(e).__name__}: {e}") from e
    inputs, nodes, outputs, consts, meta = [], [], [], {}, {}

    def as_arg(a):
        return Ref(a.name) if isinstance(a, torch.fx.Node) else a

    def value(a):
        return consts[a.name] if isinstance(a, Ref) else a

    for n in gm.graph.nodes:
        if n.op == "placeholder":
            inputs.append(n.name)
            meta[n.name] = _shape_dtype(n.meta.get("val"))
            continue
        if n.op == "get_attr":
            t = getattr(gm, n.target)
            consts[n.name] = t.detach().cpu()
            meta[n.name] = (tuple(t.shape), t.dtype)
            continue
        if n.op == "output":
            outputs = [as_arg(a) for a in (
                n.args[0] if isinstance(n.args[0], (tuple, list))
                else (n.args[0],))]
            continue
        if n.op != "call_function":
            raise GraphTraceError(f"graph node {n.op} {n.target}")
        node = GNode(n.name, _out_of_place(n.target),
                     _map_args(n.args, as_arg),
                     _map_args(dict(n.kwargs), as_arg),
                     *_shape_dtype(n.meta.get("val")))
        meta[n.name] = (node.shape, node.dtype)
        refs = _refs((node.args, node.kwargs))
        if node.op is not operator.getitem and node.opname in _SHAPE_ONLY:
            # the value of a *_like factory: run it on a zero stand-in
            stand = {r.name: torch.zeros(meta[r.name][0],
                                         dtype=meta[r.name][1])
                     for r in refs if r.name not in consts}
            node_args = _map_args(node.args, lambda a: stand.get(
                a.name, consts.get(a.name)) if isinstance(a, Ref) else a)
            consts[n.name] = run_op(node, node_args,
                                    _map_args(node.kwargs, value))
            continue
        if all(r.name in consts for r in refs):
            consts[n.name] = run_op(node, _map_args(node.args, value),
                                    _map_args(node.kwargs, value))
            continue
        nodes.append(node)
    return Graph(inputs, nodes, outputs, consts, meta)

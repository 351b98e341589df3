"""DTensor sharding rules the port registers (ROADMAP C.6, C.10).

The engines take J·v on a DTensor state as the VJP of the VJP
(``core/autodiff.py``).  A residual that reaches its components by
``X[..., k]``, ``X.unbind(-1)`` or ``torch.stack(..., -1)`` runs, in that
J·v, ops whose dimension argument is negative, and torch's rules for two
of them shift the shard dimensions past the inserted dimension by
comparing each with that negative number, so every shard moves up by one:

- ``aten.select_backward`` (torch 2.11 and 2.13), the second VJP of a
  stack or a select: under ``Shard(0)`` the output claims ``Shard(1)`` and
  its local zeros take another shard's sizes (``The size of tensor a (8)
  must match the size of tensor b (16)`` at world 2); under ``Shard(1)``
  the stacked axis itself is given the shard;
- ``aten.stack`` (torch 2.11, which normalises ``dim`` against the
  inputs' rank, not the output's): under ``Shard(1)`` the residual's own
  ``torch.stack(..., -1)`` comes back claiming ``Shard(2)``.

Each rule here makes ``dim`` non-negative against the output's rank and
then calls torch's own rule, so a call whose ``dim`` is already
non-negative gets torch's answer unchanged.  The propagator then rewrites
``select_backward``'s ``input_sizes`` to the local shard's sizes, as it
does for every op that takes a global shape.  The rules are installed
when this module is first imported (by ``parallel``, and by
``core.autodiff`` before the first J·v of a DTensor state); both torch
versions keep the rule table on ``DTensor._op_dispatcher
.sharding_propagator``.

Rules for three more ops fill gaps of older torch (ROADMAP C.10).  A
trace of every op a DTensor dispatched in the J·v of each failing idiom,
on torch 2.11 under gloo, found them:

- ``aten.roll``: torch 2.11 has no rule at all, so a residual written
  with ``torch.roll`` fails on any DTensor state.  The port registers
  torch 2.13's (``_ops/_tensor_ops.py`` ``roll_single_dim_strategy``):
  shard on the dimensions the roll leaves alone, pass partial values
  through; a shard on a rolled dimension is redistributed first.  Only
  where this torch's propagator holds no rule for ``roll``.
- ``aten.index_put`` (and its in-place forms), the VJP of ``X[..., idx]``
  (indices ``[None, None, idx]``): torch 2.11's rule asserts that the
  indices are all tensors, and its single-dimension machinery would not
  count an index inside a list that starts with ``None``.  Where this
  torch has no single-dimension rule for ``index_put`` (2.13 has one),
  the port wraps torch's rule: indices with ``None`` entries take torch
  2.13's single-dimension rule (``index_put_single_dim_strategy``: the
  indices replicated, ``self`` and the values sharded alike on the
  dimensions no index touches), expanded over the mesh by torch's own
  ``expand_to_full_mesh_op_strategy``; any other call gets torch's rule.
- ``aten.index_add``, the VJP of ``index_select``: no rule in torch 2.11
  or 2.13; 2.13 propagates it through its decomposition into
  ``index_put(self, (None,) * dim + (index,), source, accumulate=True)``
  (``torch._decomp``), which 2.11's ``index_put`` rule refuses.  Where
  this torch has no single-dimension rule for ``index_put``, the port
  registers ``index_add``'s own: the ``index_put`` rule on that
  decomposition's arguments, so it ends in 2.13's placements.

On a torch that has these rules (2.13) nothing here is registered and
the table stays torch's own.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._dtensor_spec import DTensorSpec
from torch.distributed.tensor._op_schema import (OpSchema, OpSpec, OpStrategy,
                                                 RuntimeSchemaInfo,
                                                 TupleStrategy)
from torch.distributed.tensor._ops.single_dim_strategy import (
    _ShardingPlaceholder, register_single_dim_strategy)
from torch.distributed.tensor._ops.utils import (
    expand_to_full_mesh_op_strategy)
from torch.distributed.tensor.placement_types import (Partial, Replicate,
                                                      Shard)

aten = torch.ops.aten


def _output_rank(op, args) -> int:
    if op is aten.select_backward.default:
        return len(args[1])                  # input_sizes
    return args[0].children[0].ndim + 1      # stack: one more than an input


def _non_negative_dim(torch_rule):
    """``torch_rule`` called with the op's ``dim`` (argument 1 of stack,
    2 of select_backward) made non-negative."""
    def rule(op_schema: OpSchema):
        op = op_schema.op
        at = 2 if op is aten.select_backward.default else 1
        args = list(op_schema.args_schema)
        if len(args) > at and args[at] < 0:
            args[at] += _output_rank(op, args)
            op_schema = OpSchema(op, tuple(args), op_schema.kwargs_schema,
                                 schema_info=op_schema.schema_info)
        return torch_rule(op_schema)
    return rule


def _dim(d: int, ndim: int) -> int:
    return d + ndim if d < 0 else d


def roll_strategy(op, args, kwargs):
    """``aten.roll``'s single-dimension strategies, [output, input] a row:
    torch 2.13's ``roll_single_dim_strategy``."""
    ndim = len(args[0].shape)
    dims = list(args[2]) if len(args) > 2 else []
    # a roll with no dims flattens the tensor: every dimension is active
    active = {_dim(d, ndim) for d in dims} if dims else set(range(ndim))
    rows = [[_ShardingPlaceholder(d)] * 2 for d in range(ndim)
            if d not in active]
    return rows + [[Partial(r)] * 2 for r in ("sum", "avg", "max", "min")]


def index_put_strategy(op, args, kwargs):
    """``aten.index_put``'s single-dimension strategies, [output, self,
    *the index tensors, values] a row: torch 2.13's
    ``index_put_single_dim_strategy``."""
    self_meta, indices, values_meta = args[0], args[1], args[2]
    indexed = sorted(i for i, idx in enumerate(indices) if idx is not None)
    free = [d for d in range(len(self_meta.shape)) if d not in indexed]
    shapes = [idx.shape for idx in indices if idx is not None]
    bcast_ndim = len(torch.broadcast_shapes(*shapes)) if shapes else 0
    contiguous = (len(indexed) <= 1
                  or indexed[-1] - indexed[0] + 1 == len(indexed))
    result_ndim = bcast_ndim + len(free)
    rows = []
    for i, d in enumerate(free):
        if contiguous and indexed:
            at = d if d < indexed[0] else d - len(indexed) + bcast_ndim
        else:
            at = bcast_ndim + i
        # values may have fewer dims than the result (broadcast from the
        # right); a broadcast dimension stays replicated
        vd = at - (result_ndim - len(values_meta.shape))
        vp = (Replicate() if vd < 0 or values_meta.shape[vd] == 1
              else _ShardingPlaceholder(vd))
        rows.append([_ShardingPlaceholder(d), _ShardingPlaceholder(d),
                     *([Replicate()] * len(indexed)), vp])
    rows.append([Partial(), Partial(), *([Replicate()] * len(indexed)),
                 Partial()])
    return rows


def index_add_strategy(op, args, kwargs):
    """``aten.index_add``'s single-dimension strategies, [output, self,
    index, source] a row: ``index_put``'s on its decomposition
    ``index_put(self, (None,) * dim + (index,), source)``, whose rows list
    the same tensors in the same order."""
    self_meta, dim, index, source = args[:4]
    dim = _dim(dim, len(self_meta.shape))
    return index_put_strategy(op, (self_meta, (None,) * dim + (index,),
                                   source), kwargs)


def _index_put_rule(torch_rule):
    """An ``index_put`` op strategy: indices with ``None`` entries (a list,
    not a ``TupleStrategy``, in the wrapped schema) get the rows of
    ``index_put_strategy`` plus all-replicate, expanded over the mesh
    (each index made an ``OpStrategy`` so that it is counted as an input);
    any other call gets ``torch_rule``."""
    def rule(op_schema: OpSchema):
        args = list(op_schema.args_schema)
        indices = args[1]
        entries = (list(indices.children) if isinstance(indices, TupleStrategy)
                   else list(indices))
        if torch_rule is not None and not any(e is None for e in entries):
            return torch_rule(op_schema)
        args[1] = [OpStrategy([OpSpec(e)]) if isinstance(e, DTensorSpec)
                   else e for e in entries]
        schema = OpSchema(op_schema.op, tuple(args), op_schema.kwargs_schema,
                          schema_info=op_schema.schema_info)
        meta = lambda s: s.strategies[0].output_spec.tensor_meta  # noqa
        self_meta = meta(args[0])
        rows = index_put_strategy(
            op_schema.op, (self_meta, [None if e is None else meta(e)
                                       for e in args[1]], meta(args[2])),
            op_schema.kwargs_schema)
        rows = [[Shard(q.dim) if isinstance(q, _ShardingPlaceholder) else q
                 for q in row] for row in rows]
        rows.append([Replicate()] * len(rows[0]))
        return expand_to_full_mesh_op_strategy(
            args[0].mesh, schema, rows, output_tensor_meta=self_meta,
            inplace_op=op_schema.is_inplace_op())
    return rule


def _has_rule(prop, op) -> bool:
    return any(op in table for table in (prop.op_strategy_funcs,
                                         prop.op_single_dim_strategy_funcs,
                                         prop.op_to_rules))


def register() -> None:
    """Wrap torch's rules for ``select_backward`` and ``stack``, keeping
    their cache keys (``input_sizes`` and ``dim`` are part of them); add
    the ``roll``, ``index_put`` and ``index_add`` rules where this torch
    lacks them."""
    prop = DTensor._op_dispatcher.sharding_propagator
    if prop.op_to_shape_and_stride_idx.get(
            aten.select_backward.default) != 1:
        raise RuntimeError(
            "this torch's DTensor does not rewrite select_backward's "
            "input_sizes to the local shard's")
    for op in (aten.select_backward.default, aten.stack.default):
        prop.register_op_strategy(op, _non_negative_dim(
            prop.op_strategy_funcs[op]), prop.op_to_schema_info[op])
    if not _has_rule(prop, aten.roll.default):
        register_single_dim_strategy(
            aten.roll.default, schema_info=RuntimeSchemaInfo(1))(
                roll_strategy)
    if aten.index_put.default not in prop.op_single_dim_strategy_funcs:
        for op in (aten.index_put.default, aten.index_put_.default,
                   aten._index_put_impl_.default):
            torch_rule = prop.op_strategy_funcs.get(op)
            if getattr(torch_rule, "__qualname__", "").startswith(
                    "_index_put_rule"):
                continue                # registered here already
            prop.register_op_strategy(
                op, _index_put_rule(torch_rule),
                prop.op_to_schema_info.get(
                    op, RuntimeSchemaInfo(needs_pytree=True)))
        if not _has_rule(prop, aten.index_add.default):
            register_single_dim_strategy(
                [aten.index_add.default, aten.index_add_.default],
                schema_info=RuntimeSchemaInfo(1))(index_add_strategy)


register()

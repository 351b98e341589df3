"""DTensor sharding rules the port registers (ROADMAP C.6).

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
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._op_schema import OpSchema

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


def register() -> None:
    """Wrap torch's rules for ``select_backward`` and ``stack``, keeping
    their cache keys (``input_sizes`` and ``dim`` are part of them)."""
    prop = DTensor._op_dispatcher.sharding_propagator
    if prop.op_to_shape_and_stride_idx.get(
            aten.select_backward.default) != 1:
        raise RuntimeError(
            "this torch's DTensor does not rewrite select_backward's "
            "input_sizes to the local shard's")
    for op in (aten.select_backward.default, aten.stack.default):
        prop.register_op_strategy(op, _non_negative_dim(
            prop.op_strategy_funcs[op]), prop.op_to_schema_info[op])


register()

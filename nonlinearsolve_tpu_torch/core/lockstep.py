"""Lockstep loops over a leading batch dimension (the simple tier, the
bracketing tier and their line searches): one row a trajectory, each step
taken by every row and kept by the rows still running, as a finished lane
of a vmapped ``while_loop`` keeps its carry in the JAX package."""

from __future__ import annotations

import dataclasses

import torch

from .. import _backend


def any_row(flags: torch.Tensor) -> bool:
    """True when any row's flag is set: one host read."""
    return bool(_backend.fetch(flags.any())[0])


def row_flags(flags: torch.Tensor):
    """(any row's flag is set, every row's is): one host read.  A loop
    takes a step's results without a select when every row takes it
    (always so at B = 1)."""
    some, every = _backend.fetch(torch.stack([flags.any(), flags.all()]))[0]
    return bool(some), bool(every)


def select_rows(mask, new, old):
    """``new`` where ``mask`` (B,), else ``old``, through tensors, tuples,
    dataclasses and None."""
    if new is None:
        return None
    if isinstance(new, torch.Tensor):
        return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 1)),
                           new, old)
    if isinstance(new, tuple):
        return tuple(select_rows(mask, a, b) for a, b in zip(new, old))
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: select_rows(mask, getattr(new, f.name),
                                getattr(old, f.name))
            for f in dataclasses.fields(new)})
    return new

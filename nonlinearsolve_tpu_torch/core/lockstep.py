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


def rows_matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``A[i] @ x[i]`` for each row: ``A`` (B, m, n), ``x`` (B, n) ->
    (B, m), rounded as the lone engines' matrix-vector product.  On the
    CPU each row's product is that product itself (the BLAS's gemv sums
    in an order that no batched product of torch reproduces); on the card
    it is one batched product."""
    if A.device.type == "cpu":
        return torch.stack([a @ v for a, v in zip(A, x)])
    return torch.matmul(A, x[..., None])[..., 0]


def rows_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.dot(a[i], b[i])`` for each row, rounded as the lone
    engines' ``torch.dot`` (the BLAS's ddot on the CPU, as
    ``rows_matvec``); one reduction on the card."""
    if a.device.type == "cpu":
        return torch.stack([torch.dot(x, y) for x, y in zip(a, b)])
    return (a * b).sum(-1)


def rows_vecmat(x: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """``x[i] @ A[i]`` for each row (a row vector times a matrix), rounded
    as the lone engines' product, as ``rows_matvec``."""
    if A.device.type == "cpu":
        return torch.stack([v @ a for v, a in zip(x, A)])
    return torch.matmul(x[..., None, :], A)[..., 0, :]


def pow_as_host(x: torch.Tensor, exponent: float) -> torch.Tensor:
    """``x ** exponent`` rounded as the C library's ``pow``, which the lone
    engines' host scalars (numpy) take.  On the CPU torch's vectorized
    power rounds otherwise; on a strided view it takes the element loop,
    which calls ``pow``.  That is torch's internal choice, not a promise:
    a torch upgrade must re-check it
    (``tests/test_torch_ensemble_lockstep.py``
    ``test_pow_as_host_rounds_as_the_c_library``).  On the card it is the device's ``pow``."""
    if x.device.type == "cpu":
        return torch.stack([x, x], -1)[..., 0] ** exponent
    return x ** exponent

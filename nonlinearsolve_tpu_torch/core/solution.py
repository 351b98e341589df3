"""NonlinearSolution and NLStats (the port of ``core/solution.py``).

A solve of one problem runs on the host's Python loop, so its counters are
plain ints and its retcode a ``ReturnCode``.  A batched solve (the simple
and bracketing tiers on a batch, ensembles) keeps them on the device: its
retcode is an int tensor of shape (B,), each ``NLStats`` field a (B,)
tensor, and ``success`` is element-wise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .returncode import ReturnCode, retcode_name


@dataclasses.dataclass(frozen=True)
class NLStats:
    """Solve counters (reference ``NLStats``)."""

    nf: int = 0
    njacs: int = 0
    nfactors: int = 0
    nsolve: int = 0
    nsteps: int = 0

    @staticmethod
    def zeros() -> "NLStats":
        return NLStats()

    def incr(self, *, nf=0, njacs=0, nfactors=0, nsolve=0,
             nsteps=0) -> "NLStats":
        def add(count, by):
            # a batch's counts are device tensors: adding a literal 0
            # would cost a launch and change nothing
            return count if isinstance(by, int) and by == 0 else count + by
        return NLStats(add(self.nf, nf), add(self.njacs, njacs),
                       add(self.nfactors, nfactors), add(self.nsolve, nsolve),
                       add(self.nsteps, nsteps))


@dataclasses.dataclass(frozen=True)
class NonlinearSolution:
    """Result of a nonlinear solve.

    ``u``: the solution iterate; ``resid``: f(u); ``retcode``: a
    ``ReturnCode`` (a (B,) int tensor for a batch); ``stats``: ``NLStats``.
    ``counters`` is the port's own record of what the solve cost on the
    device: Jacobian-vector products (``jvp``), Krylov iterations
    (``krylov_iters``) and host syncs (``host_syncs``).  ``original``: the
    final bracket ``(left, right)`` of a bracketing solve, or the
    initialization sub-solution of a solve aborted by it.  ``trace``: the
    stored per-iteration record (``store_trace=True``); ``timer``: seconds
    per phase (``time_phases=True``).
    """

    u: Any
    resid: Any
    retcode: ReturnCode
    stats: Optional[NLStats] = None
    counters: Optional[dict] = None

    original: Any = None
    trace: Any = None
    timer: Any = None

    @property
    def success(self):
        """A bool; for a batch, a (B,) bool tensor."""
        if isinstance(self.retcode, torch.Tensor):
            return torch.isin(self.retcode, torch.tensor(
                _SUCCESSFUL, dtype=self.retcode.dtype,
                device=self.retcode.device))
        return ReturnCode.successful(self.retcode)

    def __repr__(self):
        if isinstance(self.retcode, torch.Tensor):
            code = f"<{tuple(self.retcode.shape)} codes>"
        else:
            code = retcode_name(self.retcode)
        return (f"NonlinearSolution(retcode={code}, u={self.u!r}, "
                f"resid={self.resid!r})")


_SUCCESSFUL = [int(c) for c in ReturnCode if ReturnCode.successful(c)]

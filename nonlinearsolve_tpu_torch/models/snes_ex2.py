"""PETSc SNES example 2 (the port of ``models/snes_ex2.py``) — the
reference's head-to-head tutorial problem.

The 1D boundary-value problem ``u'' + u² = F(x)``, ``F = 6x + (x+1e-12)⁶``,
with Dirichlet conditions u(0) = 0, u(1) = 1.  Its Jacobian is tridiagonal:
the sparse path takes parallel cyclic reduction.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _backend
from ..core.problems import NonlinearFunction, NonlinearProblem


@functools.lru_cache(maxsize=16)
def _forcing(n: int, device: torch.device) -> torch.Tensor:
    """F on the grid ``linspace(0, 1, n)`` in float64, as the JAX package's
    residual computes it (its ``x⁶`` is XLA's integer power: x²·x⁴)."""
    xp = np.linspace(0.0, 1.0, n)
    s2 = (xp + 1e-12) * (xp + 1e-12)
    return torch.as_tensor(6.0 * xp + s2 * (s2 * s2), device=device)


def residual(x, _p=None):
    n = x.shape[0]
    F = _forcing(n, x.device)
    dx = 1.0 / (n - 1)
    interior = ((x[:-2] - 2.0 * x[1:-1] + x[2:]) / dx ** 2
                + x[1:-1] * x[1:-1] - F[1:-1])
    return torch.cat([x[:1], interior, x[-1:] - 1.0])


def make_problem(n: int = 128, sparse: bool = False, *, device=None):
    """u0 = 0.5 (float64) on ``device`` (the card by default); with
    ``sparse`` the tridiagonal pattern as a COO spec."""
    u0 = torch.full((n,), 0.5, dtype=torch.float64,
                    device=_backend.resolve_device(device))
    if sparse:
        rows = [0] + [i for i in range(1, n - 1) for _ in range(3)] + [n - 1]
        cols = [0] + [j for i in range(1, n - 1)
                      for j in (i - 1, i, i + 1)] + [n - 1]
        f = NonlinearFunction(f=residual,
                              sparsity=(np.array(rows), np.array(cols)))
        return NonlinearProblem(f, u0, None)
    return NonlinearProblem(residual, u0, None)

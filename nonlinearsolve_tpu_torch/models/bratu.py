"""2D Bratu problem (the port of ``models/bratu.py``) — BASELINE config 3.

``Δu + λ eᵘ = 0`` on the unit square with homogeneous Dirichlet conditions,
on an (N+2)×(N+2) grid (N×N interior unknowns), λ = 3.5 by default (below
the fold λ* ≈ 6.80812).  The classic sparse direct Newton benchmark: a
5-point Jacobian, colored sparse AD and a banded or CSR direct solve.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import _backend
from ..core.problems import NonlinearFunction, NonlinearProblem
from ..ops.sparse import CSR


def bratu_2d(u, p):
    """The residual on the (N, N) interior values ``u``; ``p`` = λ."""
    N = u.shape[0]
    h = 1.0 / (N + 1)
    up = F.pad(u, (1, 1, 1, 1))
    lap = (up[:-2, 1:-1] + up[2:, 1:-1] + up[1:-1, :-2] + up[1:-1, 2:]
           - 4.0 * u) / (h * h)
    return lap + p * torch.exp(u)


def sparsity_pattern(N: int) -> CSR:
    """The 5-point Dirichlet stencil pattern on the N×N interior."""
    idx = np.arange(N * N).reshape(N, N)
    rows_list, cols_list = [idx.ravel()], [idx.ravel()]
    for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
        shifted = np.roll(idx, shift, axis=axis)
        valid = np.ones((N, N), bool)
        if axis == 0:
            (valid[0, :] if shift == 1 else valid[-1, :])[...] = False
        else:
            (valid[:, 0] if shift == 1 else valid[:, -1])[...] = False
        rows_list.append(idx[valid].ravel())
        cols_list.append(shifted[valid].ravel())
    return CSR.from_pattern(np.concatenate(rows_list),
                            np.concatenate(cols_list), (N * N, N * N))


def make_problem(N: int = 32, lam: float = 3.5, dtype=torch.float64,
                 with_sparsity: bool = True, *, device=None):
    """u0 = 0 on ``device`` (the card by default), p = λ as a 0-d tensor."""
    dev = _backend.resolve_device(device)
    dtype = _backend.resolve_dtype(dtype)
    u0 = torch.zeros((N, N), dtype=dtype, device=dev)
    f = (NonlinearFunction(f=bratu_2d, sparsity=sparsity_pattern(N))
         if with_sparsity else bratu_2d)
    return NonlinearProblem(f, u0, torch.tensor(lam, dtype=dtype,
                                                device=dev))

"""Classic nonlinear least-squares fixtures (the port of
``models/nlls_problems.py``): the same residuals on torch tensors, with the
same starts (numpy), expected minimizers and sums of squares.

Each entry: (name, residual f(u, p), u0, expected minimizer or None,
expected ssq at the minimum).
"""

from __future__ import annotations

import numpy as np
import torch


def _const(u, values):
    return torch.tensor(values, dtype=u.dtype, device=u.device)


def _rosenbrock(u, p):
    return torch.stack([10.0 * (u[1] - u[0] ** 2), 1.0 - u[0]])


def _beale(u, p):
    x, y = u[0], u[1]
    return torch.stack([1.5 - x * (1 - y),
                        2.25 - x * (1 - y ** 2),
                        2.625 - x * (1 - y ** 3)])


def _powell_badly_scaled(u, p):
    return torch.stack([1e4 * u[0] * u[1] - 1.0,
                        torch.exp(-u[0]) + torch.exp(-u[1]) - 1.0001])


def _freudenstein_roth(u, p):
    x, y = u[0], u[1]
    return torch.stack([-13.0 + x + ((5.0 - y) * y - 2.0) * y,
                        -29.0 + x + ((y + 1.0) * y - 14.0) * y])


def _bard(u, p):
    ts = torch.arange(1.0, 16.0, dtype=u.dtype, device=u.device)
    ys = _const(u, [0.14, 0.18, 0.22, 0.25, 0.29, 0.32, 0.35, 0.39, 0.37,
                    0.58, 0.73, 0.96, 1.34, 2.10, 4.39])
    v = 16.0 - ts
    w = torch.minimum(ts, v)
    return ys - (u[0] + ts / (u[1] * v + u[2] * w))


def _gaussian_fit(u, p):
    """Exponential decay fit with exact data (zero-residual optimum)."""
    ts = _const(u, np.linspace(0.0, 1.0, 10))
    target = 2.0 * torch.exp(-1.5 * ts) + 0.5
    return u[0] * torch.exp(u[1] * ts) + u[2] - target


def _box_3d(u, p):
    ts = 0.1 * torch.arange(1.0, 11.0, dtype=u.dtype, device=u.device)
    return (torch.exp(-ts * u[0]) - torch.exp(-ts * u[1])
            - u[2] * (torch.exp(-ts) - torch.exp(-10.0 * ts)))


def _overdetermined_linear(u, p):
    """Inconsistent linear system — the nonzero-residual minimum."""
    A = _const(u, [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    b = _const(u, [1.0, 1.0, 0.0])
    return A @ u - b


NLLS_PROBLEMS = [
    ("rosenbrock", _rosenbrock, np.array([-1.2, 1.0]),
     np.array([1.0, 1.0]), 0.0),
    ("beale", _beale, np.array([1.0, 1.0]), np.array([3.0, 0.5]), 0.0),
    ("powell_badly_scaled", _powell_badly_scaled, np.array([0.0, 1.0]),
     None, 0.0),
    ("freudenstein_roth", _freudenstein_roth, np.array([6.0, 4.0]),
     np.array([5.0, 4.0]), 0.0),
    ("bard", _bard, np.array([1.0, 1.0, 1.0]), None, 8.2149e-3),
    ("exp_fit", _gaussian_fit, np.array([1.0, -1.0, 0.0]), None, 0.0),
    ("box_3d", _box_3d, np.array([0.0, 10.0, 20.0]), None, 0.0),
    ("overdetermined_linear", _overdetermined_linear, np.array([0.0, 0.0]),
     np.array([1.0 / 3.0, 1.0 / 3.0]), 4.0 / 3.0),
]

"""The 23-problem robustness suite (the port of ``models/problems23.py``):
the same residuals on torch tensors, the same float64 starts (numpy),
indices and titles.  Each ``f(x, p)`` takes a 1-d tensor and works under
``torch.func`` (``vmap``, ``jvp``, ``jacfwd``, ``jacrev``): constants are
made on ``x``'s device in its dtype, and no residual reads ``x`` on the
host.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TestProblem:
    index: int
    title: str
    f: Callable
    start: np.ndarray


def _ar(x, start, stop):
    """``arange(start, stop)`` in ``x``'s dtype on its device."""
    return torch.arange(start, stop, dtype=x.dtype, device=x.device)


def _vec(*entries):
    return torch.stack(entries)


def _rosenbrock(x, p=None):
    f1 = 1.0 - x[0]
    # x[1:] - x[:-1]² in one rounding, as XLA fuses the JAX package's: the
    # NewtonRaphson trajectory on this problem is chaotic, so an ulp here
    # decides whether it converges
    rest = 10.0 * torch.addcmul(x[1:], x[:-1], x[:-1], value=-1.0)
    return torch.cat([f1.reshape(1), rest])


def _powell_singular(x, p=None):
    return _vec(
        x[0] + 10.0 * x[1],
        math.sqrt(5.0) * (x[2] - x[3]),
        (x[1] - 2.0 * x[2]) ** 2,
        math.sqrt(10.0) * (x[0] - x[3]) ** 2,
    )


def _powell_badly_scaled(x, p=None):
    return _vec(
        1e4 * x[0] * x[1] - 1.0,
        torch.exp(-x[0]) + torch.exp(-x[1]) - 1.0001,
    )


def _wood(x, p=None):
    x1, x2, x3, x4 = x[0], x[1], x[2], x[3]
    return _vec(
        -200.0 * x1 * (x2 - x1 ** 2) - (1.0 - x1),
        200.0 * (x2 - x1 ** 2) + 20.2 * (x2 - 1.0) + 19.8 * (x4 - 1.0),
        -180.0 * x3 * (x4 - x3 ** 2) - (1.0 - x3),
        180.0 * (x4 - x3 ** 2) + 20.2 * (x4 - 1.0) + 19.8 * (x2 - 1.0),
    )


def _helical_valley(x, p=None):
    x1, x2, x3 = x[0], x[1], x[2]
    theta = torch.atan2(x2, x1) / (2.0 * math.pi)
    return _vec(
        10.0 * (x3 - 10.0 * theta),
        10.0 * (torch.sqrt(x1 ** 2 + x2 ** 2) - 1.0),
        x3,
    )


def _watson_residuals(x):
    """The 31 Watson residuals (MGH #20)."""
    n = x.shape[0]
    t = _ar(x, 1, 30) / 29.0
    powers = _ar(x, 0, n)
    # Σ_j x_j t^{j-1} and Σ_j (j-1) x_j t^{j-2}
    poly = torch.sum(x[None, :] * t[:, None] ** powers[None, :], dim=1)
    dpoly = torch.sum(x[None, 1:] * powers[None, 1:]
                      * t[:, None] ** (powers[None, 1:] - 1), dim=1)
    r = dpoly - poly ** 2 - 1.0
    return torch.cat([r, _vec(x[0], x[1] - x[0] ** 2 - 1.0)])


def _watson(x, p=None):
    """Square system via the stationarity conditions ∇½‖r‖² = Jᵀr = 0."""
    return torch.func.grad(
        lambda y: 0.5 * torch.sum(_watson_residuals(y) ** 2))(x)


def _chebyquad(x, p=None):
    """Chebyquad (MGH #35), square n=2 variant."""
    n = x.shape[0]
    y = 2.0 * x - 1.0
    Ts = [y, 2.0 * y * y - 1.0]
    for _ in range(2, n):
        Ts.append(2.0 * y * Ts[-1] - Ts[-2])
    out = []
    for i in range(1, n + 1):
        integral = 0.0 if i % 2 == 1 else -1.0 / (i * i - 1.0)
        out.append(torch.mean(Ts[i - 1]) - integral)
    return torch.stack(out)


def _chain(op, x):
    """``op``-reduce ``x`` left to right, one element at a time: the order
    XLA's CPU reduction takes at this size, and the same on any device."""
    out = x[0]
    for i in range(1, x.shape[0]):
        out = op(out, x[i])
    return out


def _brown_almost_linear(x, p=None):
    # the sum and product as chains: this Newton path is chaotic (its
    # first step reaches |x| ≈ 5e3), so the reductions' order matters
    n = x.shape[0]
    s = _chain(torch.add, x)
    head = x[:-1] + s - (n + 1.0)
    tail = _chain(torch.mul, x) - 1.0
    return torch.cat([head, tail.reshape(1)])


def _pad0(x):
    z = torch.zeros(1, dtype=x.dtype, device=x.device)
    return torch.cat([z, x, z])


def _discrete_bvp(x, p=None):
    n = x.shape[0]
    h = 1.0 / (n + 1.0)
    t = h * _ar(x, 1, n + 1)
    xp = _pad0(x)
    return (2.0 * xp[1:-1] - xp[:-2] - xp[2:]
            + (h ** 2) * (xp[1:-1] + t + 1.0) ** 3 / 2.0)


def _discrete_integral(x, p=None):
    n = x.shape[0]
    h = 1.0 / (n + 1.0)
    t = h * _ar(x, 1, n + 1)
    cube = (x + t + 1.0) ** 3
    lower = torch.cumsum(t * cube, dim=0)              # Σ_{j≤i} t_j (…)³
    total_upper = torch.flip(torch.cumsum(
        torch.flip((1.0 - t) * cube, [0]), dim=0), [0])
    upper = total_upper - (1.0 - t) * cube             # Σ_{j>i} (1-t_j)(…)³
    return x + h * ((1.0 - t) * lower + t * upper) / 2.0


def _trigonometric(x, p=None):
    n = x.shape[0]
    i = _ar(x, 1, n + 1)
    return n - torch.sum(torch.cos(x)) + i * (1.0 - torch.cos(x)) \
        - torch.sin(x)


def _variably_dimensioned(x, p=None):
    n = x.shape[0]
    j = _ar(x, 1, n + 1)
    s = torch.sum(j * (x - 1.0))
    return (x - 1.0) + j * s + 2.0 * j * s ** 3


def _broyden_tridiagonal(x, p=None):
    xp = _pad0(x)
    return ((3.0 - 2.0 * xp[1:-1]) * xp[1:-1] - xp[:-2] - 2.0 * xp[2:] + 1.0)


def _broyden_banded(x, p=None):
    n = x.shape[0]
    i = torch.arange(n, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    in_band = ((j >= torch.clamp(i - 5, min=0))
               & (j <= torch.clamp(i + 1, max=n - 1)) & (j != i))
    contrib = torch.where(in_band, x[None, :] * (1.0 + x[None, :]),
                          torch.zeros((), dtype=x.dtype, device=x.device))
    return x * (2.0 + 5.0 * x ** 2) + 1.0 - torch.sum(contrib, dim=1)


def _matrix(x, rows):
    return torch.tensor(rows, dtype=x.dtype, device=x.device)


def _hammarling_2x2(x, p=None):
    """Matrix square root X² = A, A = [[1.0001, 1], [0, 1.0001]] (the JAX
    package's pinned variant)."""
    X = x.reshape(2, 2)
    A = _matrix(x, [[1.0001, 1.0], [0.0, 1.0001]])
    return (X @ X - A).reshape(-1)


def _hammarling_3x3(x, p=None):
    X = x.reshape(3, 3)
    A = _matrix(x, [[1.0001, 1.0, 0.0], [0.0, 1.0001, 1.0],
                    [0.0, 0.0, 1.0001]])
    return (X @ X - A).reshape(-1)


def _dennis_schnabel(x, p=None):
    """x1 + x2 = 3, x1² + x2² = 9 from (1, 5), root (0, 3)."""
    return _vec(x[0] + x[1] - 3.0, x[0] ** 2 + x[1] ** 2 - 9.0)


def _exponential_fn(x, p=None):
    """La Cruz–Martínez–Raydan exponential function 2."""
    n = x.shape[0]
    i = _ar(x, 2, n + 1)
    head = torch.exp(x[0]) - 1.0
    tail = (i / 10.0) * (torch.exp(x[1:]) + x[:-1] - 1.0)
    return torch.cat([head.reshape(1), tail])


def _logarithmic_fn(x, p=None):
    """La Cruz–Martínez–Raydan logarithmic function."""
    n = x.shape[0]
    return torch.log(x + 1.0) - x / n


def _scalar_prob(x, p=None):
    return x * (x - 5.0) ** 2


def _freudenstein_roth(x, p=None):
    x1, x2 = x[0], x[1]
    return _vec(
        -13.0 + x1 + ((5.0 - x2) * x2 - 2.0) * x2,
        -29.0 + x1 + ((x2 + 1.0) * x2 - 14.0) * x2,
    )


def _boggs(x, p=None):
    """Boggs (1971), root (0, 1), from (1, 1)."""
    return _vec(x[0] ** 2 - x[1] + 1.0,
                x[0] - torch.cos(math.pi * x[1] / 2.0))


def _chandrasekhar(x, p=None):
    n = x.shape[0]
    c = 0.9
    mu = (_ar(x, 1, n + 1) - 0.5) / n
    kernel = mu[:, None] / (mu[:, None] + mu[None, :])
    integral = (c / (2.0 * n)) * kernel @ x
    return x - 1.0 / (1.0 - integral)


def _mk(index, title, f, start):
    return TestProblem(index, title, f, np.asarray(start, np.float64))


N = 10
PROBLEMS_23 = (
    _mk(1, "Generalized Rosenbrock function", _rosenbrock,
        [-1.2] + [1.0] * (N - 1)),
    _mk(2, "Powell singular function", _powell_singular, [3.0, -1.0, 0.0, 1.0]),
    _mk(3, "Powell badly scaled function", _powell_badly_scaled, [0.0, 1.0]),
    _mk(4, "Wood function", _wood, [-3.0, -1.0, -3.0, -1.0]),
    _mk(5, "Helical valley function", _helical_valley, [-1.0, 0.0, 0.0]),
    _mk(6, "Watson function", _watson, [0.0] * 6),
    _mk(7, "Chebyquad function", _chebyquad, [1.0 / 3.0, 2.0 / 3.0]),
    _mk(8, "Brown almost linear function", _brown_almost_linear, [0.5] * N),
    _mk(9, "Discrete boundary value function", _discrete_bvp,
        [t * (t - 1.0) for t in (np.arange(1, N + 1) / (N + 1))]),
    _mk(10, "Discrete integral equation function", _discrete_integral,
        [t * (t - 1.0) for t in (np.arange(1, N + 1) / (N + 1))]),
    _mk(11, "Trigonometric function", _trigonometric, [1.0 / N] * N),
    _mk(12, "Variably dimensioned function", _variably_dimensioned,
        list(1.0 - np.arange(1, N + 1) / N)),
    _mk(13, "Broyden tridiagonal function", _broyden_tridiagonal, [-1.0] * N),
    _mk(14, "Broyden banded function", _broyden_banded, [-1.0] * N),
    _mk(15, "Hammarling 2x2 matrix square root", _hammarling_2x2,
        [1.0, 0.0, 0.0, 1.0]),
    _mk(16, "Hammarling 3x3 matrix square root", _hammarling_3x3,
        [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]),
    _mk(17, "Dennis and Schnabel 2x2 example", _dennis_schnabel, [1.0, 5.0]),
    _mk(18, "Sample problem 18 (exponential function)", _exponential_fn,
        [1.0 / (4.0 * N * N)] * N),
    _mk(19, "Sample problem 19 (logarithmic function)", _logarithmic_fn,
        [1.0] * N),
    _mk(20, "Scalar problem f(x) = x(x - 5)^2", _scalar_prob, [1.1]),
    _mk(21, "Freudenstein-Roth function", _freudenstein_roth, [0.5, -2.0]),
    _mk(22, "Boggs function", _boggs, [1.0, 1.0]),
    _mk(23, "Chandrasekhar function", _chandrasekhar, [1.0] * N),
)

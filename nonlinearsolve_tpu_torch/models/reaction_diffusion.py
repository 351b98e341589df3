"""3D reaction–diffusion steady state (the port of
``models/reaction_diffusion.py``, BASELINE config 5).

``F(u) = D Δu + u − u³ + g(x, y, z) = 0`` on an N³ periodic grid with
h = 1/N and forcing ``g = 0.5·sin(2πx)·cos(2πy)·sin(2πz)``.  The residual is
rolls and elementwise operations; its Jacobian-vector product is kernel K9
(``ops.stencil3d.rd3d_jvp_blocked``) when the problem is built with
``kernel_jvp=True``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _backend
from ..core.problems import NonlinearFunction, NonlinearProblem


def forcing(N: int, dtype=torch.float64, *, device=None) -> torch.Tensor:
    """The forcing field, computed in f64 on the host (the JAX package's
    numpy formula), then cast: equal to the JAX package's bit for bit."""
    dev = _backend.resolve_device(device)
    xyz = np.linspace(0.0, 1.0, N, endpoint=False)
    x = xyz[:, None, None]
    y = xyz[None, :, None]
    z = xyz[None, None, :]
    g = 0.5 * np.sin(2 * np.pi * x) * np.cos(2 * np.pi * y) \
        * np.sin(2 * np.pi * z)
    g = np.broadcast_to(g, (N, N, N)).astype(_backend.np_dtype(dtype))
    return torch.as_tensor(g, device=dev)


def reaction_diffusion_3d(u: torch.Tensor, p) -> torch.Tensor:
    """u: (N, N, N); p = (D, g) with g the forcing field."""
    D, g = p
    N = u.shape[0]
    h = 1.0 / N
    roll = _backend.roll
    lap = (roll(u, 1, 0) + roll(u, -1, 0)
           + roll(u, 1, 1) + roll(u, -1, 1)
           + roll(u, 1, 2) + roll(u, -1, 2) - 6.0 * u) / (h * h)
    return D * lap + u - u ** 3 + g


def _kernel_jvp(bz: int):
    from ..ops.stencil3d import rd3d_jvp_blocked

    def jvp(v, U, p):
        return rd3d_jvp_blocked(U, v, p[0], bz=bz, double_buffer=True)
    return jvp


def problem(u0: torch.Tensor, p, *, kernel_jvp: bool = False,
            bz: int = 4) -> NonlinearProblem:
    """The steady-state problem at state ``u0`` with ``p = (D, g)``.
    ``kernel_jvp=True`` attaches kernel K9 as the analytic jvp (``bz`` must
    divide N); otherwise the operator differentiates the residual with
    ``torch.func.jvp``."""
    N = int(u0.shape[0])
    if kernel_jvp and N % bz:
        raise ValueError(f"kernel_jvp needs bz ({bz}) | N ({N})")
    f = NonlinearFunction(f=reaction_diffusion_3d,
                          jvp=_kernel_jvp(bz) if kernel_jvp else None)
    return NonlinearProblem(f, u0, p)


def make_problem(N: int = 32, D: float = 0.01, dtype=torch.float64, *,
                 kernel_jvp: bool = False, bz: int = 4,
                 device=None) -> NonlinearProblem:
    """Build the problem on ``device`` (the card by default): u0 = 0.1
    everywhere, p = (D, forcing(N)) in ``dtype``.  ``kernel_jvp=True`` is the
    counterpart of the JAX package's ``pallas_jvp=True``."""
    dev = _backend.resolve_device(device)
    dt = _backend.resolve_dtype(dtype)
    u0 = torch.full((N, N, N), 0.1, dtype=dt, device=dev)
    p = (torch.tensor(D, dtype=dt, device=dev), forcing(N, dt, device=dev))
    return problem(u0, p, kernel_jvp=kernel_jvp, bz=bz)

"""2D Brusselator steady state (the port of ``models/brusselator.py``).

N×N periodic grid, dx = 1/(N-1), state U[i, j, :] = (u, v), parameters
p = (A, B, alpha, dx) = (3.4, 1.0, 10.0, 1/(N-1)), forcing
5·1[(x-0.3)² + (y-0.6)² ≤ 0.01].

The forcing disk's edge sits at ulp level, so its mask is built once on the
host to reproduce the JAX package's exactly: its grid is
``jnp.linspace(0, 1, N, dtype)``, which XLA evaluates as
``iota · (1/(N-1))`` in the working dtype with the endpoint set to 1 (not
``iota / (N-1)``, and neither ``torch.linspace`` nor a cast f64 grid agree
with it).  The mask is then moved to the residual's device and cached.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _backend
from ..core.problems import NonlinearFunction, NonlinearProblem
from ..ops.sparse import CSR


def grid(N: int, dtype=torch.float64) -> np.ndarray:
    """The JAX package's ``jnp.linspace(0, 1, N, dtype)``, value for value."""
    npdt = _backend.np_dtype(dtype)
    if N == 1:
        return np.zeros(1, npdt)
    step = npdt(1) / npdt(N - 1)
    return np.concatenate([np.arange(N - 1, dtype=npdt) * step,
                           np.ones(1, npdt)])


def forcing_mask(N: int, dtype=torch.float64) -> np.ndarray:
    """The forced points, computed in ``dtype`` as the JAX residual does."""
    npdt = _backend.np_dtype(dtype)
    xy = grid(N, dtype)
    x = xy[:, None]
    y = xy[None, :]
    return ((x - npdt(0.3)) ** 2 + (y - npdt(0.6)) ** 2) <= npdt(0.01)


@functools.lru_cache(maxsize=16)
def _force(N: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    # never written to: shared by every residual call at this size; a
    # complex state takes the mask of its real dtype
    real = _backend.real_dtype(dtype)
    force = 5.0 * forcing_mask(N, real).astype(_backend.np_dtype(real))
    return torch.as_tensor(force, device=device).to(dtype)


def init_u0(N: int, dtype=torch.float64, *, device=None) -> torch.Tensor:
    """init_brusselator_2d: computed in f64 on the host, then cast."""
    dev = _backend.resolve_device(device)
    xy = np.linspace(0.0, 1.0, N)
    x = xy[:, None]
    y = xy[None, :]
    u = 22.0 * (y * (1.0 - y)) ** 1.5 * np.ones((N, N))
    v = 27.0 * (x * (1.0 - x)) ** 1.5 * np.ones((N, N))
    U = np.stack([u, v], axis=-1).astype(_backend.np_dtype(dtype))
    return torch.as_tensor(U, device=dev)


def default_p(N: int, dtype=torch.float64, *, device=None) -> torch.Tensor:
    dev = _backend.resolve_device(device)
    return torch.tensor([3.4, 1.0, 10.0, 1.0 / (N - 1)],
                        dtype=_backend.resolve_dtype(dtype), device=dev)


def brusselator_2d(U: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Residual F(U) with periodic BCs; U has shape (N, N, 2)."""
    A, B, alpha, dx = p[0], p[1], p[2], p[3]
    alpha = alpha / dx ** 2
    u = U[..., 0]
    v = U[..., 1]
    force = _force(int(u.shape[0]), U.dtype, U.device)

    def lap(w):
        roll = _backend.roll
        return (roll(w, 1, 0) + roll(w, -1, 0)
                + roll(w, 1, 1) + roll(w, -1, 1) - 4.0 * w)

    du = alpha * lap(u) + B + u * u * v - (A + 1.0) * u + force
    dv = alpha * lap(v) + A * u - u * u * v
    return torch.stack([du, dv], dim=-1)


def _kernel_jvp(v, U, p):
    from ..ops.stencil import brusselator_jvp
    return brusselator_jvp(U, v, p)


def problem(u0: torch.Tensor, p: torch.Tensor,
            kernel_jvp: bool = False) -> NonlinearProblem:
    """The steady-state problem at the given state and parameters.
    ``kernel_jvp=True`` attaches kernel K1 (``ops.stencil.brusselator_jvp``)
    as the analytic jvp; otherwise the operator differentiates the residual
    with ``torch.func.jvp``."""
    f = NonlinearFunction(f=brusselator_2d,
                          jvp=_kernel_jvp if kernel_jvp else None)
    return NonlinearProblem(f, u0, p)


def sparsity_pattern(N: int) -> CSR:
    """The Jacobian's sparsity (the periodic 5-point stencil plus the local
    u↔v coupling, 12 nonzeros per grid point) in the flattened (i, j, comp)
    C order, as a CSR pattern: the ``jac_prototype`` of the sparse path."""
    idx = np.arange(N * N * 2).reshape(N, N, 2)
    rows_list = []
    cols_list = []

    def add(r, c):
        rows_list.append(r.ravel())
        cols_list.append(c.ravel())

    for comp in range(2):
        r = idx[:, :, comp]
        add(r, r)                               # self
        add(r, idx[:, :, 1 - comp])             # the other component
        for shift, axis in ((1, 0), (-1, 0), (1, 1), (-1, 1)):
            add(r, np.roll(idx[:, :, comp], shift, axis=axis))
    return CSR.from_pattern(np.concatenate(rows_list),
                            np.concatenate(cols_list), (N * N * 2, N * N * 2))


def make_problem(N: int = 32, dtype=torch.float64, *,
                 kernel_jvp: bool = False, with_sparsity: bool = False,
                 device=None) -> NonlinearProblem:
    """Build the steady-state problem on ``device`` (the card by default).
    ``kernel_jvp=True`` is the counterpart of the JAX package's
    ``pallas_jvp=True``; ``with_sparsity=True`` attaches
    ``sparsity_pattern(N)`` (the problem stays shaped (N, N, 2), as in the
    JAX package; the sparse Krylov path needs the flat formulation)."""
    dev = _backend.resolve_device(device)
    u0, p = init_u0(N, dtype, device=dev), default_p(N, dtype, device=dev)
    if with_sparsity:
        return NonlinearProblem(
            NonlinearFunction(f=brusselator_2d, sparsity=sparsity_pattern(N)),
            u0, p)
    return problem(u0, p, kernel_jvp)


def brusselator_2d_df32(U_hi: torch.Tensor, U_lo: torch.Tensor, p):
    """The residual evaluated in double-f32 (``ops/doublef32.py``): the
    state is the unevaluated sum ``U_hi + U_lo``, and every term — the
    Laplacian's scaling alpha/dx² (~2.6e6 at N=512, the dominant f32
    noise), the cubic reaction, the forcing — is carried as an error-free
    pair (~1e-14 relative).  Feeds the mixed-precision refinement loop
    (``solvers/refinement.py``).  Returns ``(F_hi, F_lo)``.

    The constants are split exactly from float64 on the host, so ``p``
    must be concrete (a tensor or a sequence of four numbers); the forcing
    is the JAX package's df32 one, on the float64 grid."""
    from ..ops.doublef32 import (DF, df_add, df_add_f, df_from_f64, df_mul,
                                 df_mul_f, df_roll, df_sub)

    dtype, dev = U_hi.dtype, U_hi.device
    if isinstance(p, torch.Tensor):
        p = p.detach().cpu().numpy()
    A64, B64, alpha64, dx64 = np.asarray(p, np.float64).tolist()

    def const(v):
        return df_from_f64(v, dtype, device=dev)

    alpha_df = const(alpha64 / dx64 ** 2)
    A_df = const(A64)
    A1_df = const(A64 + 1.0)
    B_df = const(B64)

    u = DF(U_hi[..., 0], U_lo[..., 0])
    v = DF(U_hi[..., 1], U_lo[..., 1])
    N = u.hi.shape[0]
    xy = np.linspace(0.0, 1.0, N)
    x = xy[:, None]
    y = xy[None, :]
    force = torch.as_tensor(
        5.0 * (((x - 0.3) ** 2 + (y - 0.6) ** 2) <= 0.01), dtype=dtype,
        device=dev)

    def lap(w: DF) -> DF:
        s = df_add(df_roll(w, 1, 0), df_roll(w, -1, 0))
        s = df_add(s, df_add(df_roll(w, 1, 1), df_roll(w, -1, 1)))
        return df_sub(s, df_mul_f(w, torch.tensor(4.0, dtype=dtype,
                                                  device=dev)))

    def bcast(c: DF, shape) -> DF:
        return DF(c.hi.expand(shape), c.lo.expand(shape))

    shape = u.hi.shape
    uuv = df_mul(df_mul(u, u), v)
    du = df_add(df_mul(bcast(alpha_df, shape), lap(u)),
                df_add(bcast(B_df, shape), uuv))
    du = df_sub(du, df_mul(bcast(A1_df, shape), u))
    du = df_add_f(du, force)
    dv = df_sub(df_add(df_mul(bcast(alpha_df, shape), lap(v)),
                       df_mul(bcast(A_df, shape), u)), uuv)
    F_hi = torch.stack([du.hi, dv.hi], dim=-1)
    F_lo = torch.stack([du.lo, dv.lo], dim=-1)
    return F_hi, F_lo

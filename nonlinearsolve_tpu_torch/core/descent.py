"""Descent directions (the port of ``core/descent.py``): ``NewtonDescent``
with the Krylov route of ``_newton_solve``, on the matrix-free operator or
a sparse Jacobian (CSR, DIA), and the built-in Jacobi preconditioner.  The
dense route is ROADMAP A.32, the sparse direct route A.23 and the damped /
dogleg / geodesic descents A.13."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .._backend import np_dtype
from ..ops.linear_solve import LinearSolver
from ..ops.operators import StatefulJacobianOperator, as_matvec


@dataclasses.dataclass(frozen=True)
class DescentCtx:
    """Context handed to descent policies."""

    f_flat: Callable            # f(u) -> fu, on the shaped iterate
    n_in: int
    n_out: int

    @property
    def square(self) -> bool:
        return self.n_in == self.n_out


@dataclasses.dataclass(frozen=True)
class DescentResult:
    du: Any
    success: Any                # 0-d device bool
    linsolve_success: Any
    nf: int = 0                 # extra residual evaluations performed
    nsolve: int = 1
    nfactors: int = 1
    krylov_iters: int = 0
    njvp: int = 0               # products with J in the linear solve


@dataclasses.dataclass(frozen=True)
class NewtonDescent:
    linsolve: LinearSolver = LinearSolver()


def descent_init(cfg, ctx: DescentCtx, J, fu, u):
    if isinstance(cfg, NewtonDescent):
        return None
    raise NotImplementedError(
        f"descent {type(cfg).__name__} is ROADMAP A.13")


def _matrix_precond(cfg: LinearSolver, J):
    """Built-in preconditioners for materialized Jacobians: 'jacobi'
    scales by the diagonal (none for the matrix-free operator, as in the
    JAX package); 'device_lu' is ROADMAP A.23."""
    if cfg.precond == "device_lu":
        raise NotImplementedError(
            "precond='device_lu' (the device-applied sparse LU) is ROADMAP "
            "A.23")
    if cfg.precond != "jacobi" or isinstance(J, StatefulJacobianOperator):
        return None
    diag = J.diagonal()
    safe = torch.where(diag == 0, torch.ones_like(diag), diag)
    return lambda x: x / safe


# LinearSolver.krylov_basis_dtype → the GMRES basis dtype (the JAX
# package's table; a name outside it raises KeyError there too)
_BASIS_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                 "f16": torch.float16}


def _newton_solve(cfg: NewtonDescent, ctx: DescentCtx, J, fu,
                  krylov_rtol=None, u=None):
    """Krylov route: solve J δu = -fu with J a matrix-free operator or a
    sparse container.  Returns ``(δu, ok, krylov_iterations, products)``
    with ``ok`` a 0-d device bool and ``products`` the number of products
    with J."""
    from ..ops.krylov import solve_krylov
    from ..ops.sparse import CSR, DIA

    is_operator = isinstance(J, StatefulJacobianOperator)
    if not (cfg.linsolve.is_krylov or is_operator):
        if isinstance(J, (CSR, DIA)):
            raise NotImplementedError(
                f"linear solver {cfg.linsolve.method!r} on a sparse Jacobian "
                f"(the sparse direct route) is ROADMAP A.23; use "
                f"LinearSolver(method='gmres')")
        raise NotImplementedError(
            f"linear solver {cfg.linsolve.method!r} on a concrete Jacobian "
            f"is ROADMAP A.32")
    if not ctx.square:
        raise NotImplementedError(
            "non-square systems (normal-form Krylov least squares) are "
            "ROADMAP A.33")
    if isinstance(J, (CSR, DIA)) and u is not None and u.dim() > 1:
        raise NotImplementedError(
            "a sparse Jacobian with a Krylov solver needs a flat state "
            "(u0.reshape(-1), and a residual on flat vectors): on a state of "
            f"shape {tuple(u.shape)} the JAX package fails as well (ROADMAP "
            "C)")
    method = cfg.linsolve.method if cfg.linsolve.is_krylov else "gmres"
    if is_operator:
        base = J
    elif isinstance(J, CSR):
        base = J.matvec_fn()        # staged: any repack runs once per step
    else:
        base = as_matvec(J)
    products = [0]

    def matvec(v):
        products[0] += 1
        return base(v)

    npdt = np_dtype(fu.dtype)
    rtol = (krylov_rtol if krylov_rtol is not None
            else float(np.sqrt(np.finfo(npdt).eps)))
    if cfg.linsolve.precond_fn is not None:
        if getattr(cfg.linsolve.precond_fn, "wants_residual", False):
            raise NotImplementedError(
                "residual-aware preconditioner factories are ROADMAP A.24")
        # Contract: precond_fn(u) -> (v -> M⁻¹v); a plain v -> M⁻¹v
        # callable (u-independent) is accepted too.  As in the JAX package,
        # the factory is always called first: a plain callable then returns
        # an array (one preconditioner application, wasted, per Newton step)
        # and is used itself.  The wasted call is kept so that the iterates
        # and stats match the JAX package's.
        M = cfg.linsolve.precond_fn(u)
        if not callable(M):
            M = cfg.linsolve.precond_fn
    else:
        M = _matrix_precond(cfg.linsolve, J)
    kw = {}
    if method == "gmres" and cfg.linsolve.krylov_basis_dtype:
        kw["basis_dtype"] = _BASIS_DTYPES[cfg.linsolve.krylov_basis_dtype]
    res = solve_krylov(method, matvec, fu, restart=cfg.linsolve.restart,
                       maxiter=cfg.linsolve.krylov_maxiter, rtol=rtol, M=M,
                       **kw)
    return -res.x, torch.isfinite(res.x).all(), res.iterations, products[0]


def descent_solve(cfg, state, ctx: DescentCtx, J, fu, u, krylov_rtol=None):
    """Compute δu.  Returns (DescentResult, new_state)."""
    if isinstance(cfg, NewtonDescent):
        du, ok, iters, products = _newton_solve(cfg, ctx, J, fu,
                                                krylov_rtol, u)
        return DescentResult(du=du, success=ok, linsolve_success=ok,
                             krylov_iters=iters, njvp=products), state
    raise NotImplementedError(
        f"descent {type(cfg).__name__} is ROADMAP A.13")

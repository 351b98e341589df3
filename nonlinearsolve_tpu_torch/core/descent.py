"""Descent directions (the port of ``core/descent.py``):

* ``NewtonDescent`` — ``J δu = -fu``: the Krylov route on the matrix-free
  operator or a sparse Jacobian (CSR, DIA; a non-square system solves the
  normal equations JᵀJ δu = -Jᵀfu, Jᴴ when complex), the sparse direct route
  (``ops/direct_sparse.py``; ``sparse_lu_device``: ``ops/device_lu.py``),
  the dense route (``solve_dense`` for square systems, least squares
  otherwise);
* ``SteepestDescent`` — ``δu = -Jᵀ fu``;
* ``DampedNewtonDescent`` — ``(JᵀJ + λDᵀD) δu = -Jᵀfu`` in the four modes
  simple / least_squares / normal_form / minimum_norm;
* ``Dogleg`` — the trust-region switch between Newton and Cauchy;
* ``GeodesicAcceleration`` — the LM second-order correction with its
  accept test ``2‖a‖ ≤ α‖v‖``.

Protocol: ``descent_init(cfg, ctx, J, fu, u) -> state``;
``descent_solve(cfg, state, ctx, J, fu, u, trust_region=None) ->
(DescentResult, state)``; ``descent_post_step(cfg, state, accepted) ->
state`` (LM's λ update).  Everything a descent decides from device values
(Dogleg's branch, the geodesic accept test) is a ``torch.where`` on the
device: a descent reads nothing itself, except where a route's host call
reads J (the sparse direct route's host LU and the device LU's refresh).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .._backend import real_np_dtype
from ..ops.linear_solve import LinearSolver, _lstsq, solve_dense, solve_spd
from ..ops.operators import (StatefulJacobianNormalFormOperator,
                             StatefulJacobianOperator, as_matvec, mv, rmv,
                             rmv_t)
from ..utils import ordering
from ..utils.norms import l2_norm, tree_dot
from . import damping as dmp


@dataclasses.dataclass(frozen=True)
class DescentCtx:
    """Context handed to descent policies."""

    f_flat: Callable            # f(u) -> fu, on the shaped iterate
    n_in: int
    n_out: int
    is_least_squares: bool = False
    out_shape: Any = None       # the residual's shape (the simple tier)
    # the iterate corrector H(u_proposed, u_prev) -> u at every commit point
    postcondition: Callable = None
    trace: Any = None           # core.tracing.TraceConfig or None
    verbosity: Any = None       # core.verbosity.NonlinearVerbosity or None
    timer: Any = None           # core.timer.PhaseTimer or None

    def mark(self, phase: str) -> None:
        if self.timer is not None:
            self.timer.mark(phase)

    @property
    def square(self) -> bool:
        return self.n_in == self.n_out


@dataclasses.dataclass(frozen=True)
class DescentResult:
    du: Any
    success: Any                # 0-d device bool
    linsolve_success: Any
    duJtJdu: Any = None         # ‖J δu‖² where cheaply known, else NaN
    v: Any = None               # the geodesic velocity (None otherwise)
    nf: int = 0                 # extra residual evaluations performed
    nsolve: int = 1
    nfactors: int = 1
    krylov_iters: int = 0
    njvp: int = 0               # products with J in the linear solve


def _nan_like(x):
    return torch.full((), float("nan"), dtype=x.dtype, device=x.device)


def _ok_result(du, **kw):
    true = torch.ones((), dtype=torch.bool, device=du.device)
    return DescentResult(du=du, success=true, linsolve_success=true,
                         duJtJdu=_nan_like(du), **kw)


@dataclasses.dataclass(frozen=True)
class NewtonDescent:
    linsolve: LinearSolver = LinearSolver()


@dataclasses.dataclass(frozen=True)
class SteepestDescent:
    pass


@dataclasses.dataclass(frozen=True)
class DampedNewtonDescent:
    initial_damping: float = 1.0
    damping: Any = None          # LevenbergMarquardtDamping | SER
    linsolve: LinearSolver = LinearSolver()
    mode: str = "auto"   # 'auto'|'simple'|'least_squares'|'normal_form'|'minimum_norm'

    def resolve_mode(self, ctx: DescentCtx) -> str:
        """The JAX package's choice: underdetermined least squares with
        normal-form damping → 'minimum_norm'; SER's scalar damping →
        'simple'; a Cholesky solver → 'normal_form'; else the stacked
        'least_squares' system."""
        if self.mode != "auto":
            return self.mode
        nf_damping = self.damping.returns_norm_form_damping
        if ctx.is_least_squares and ctx.n_out < ctx.n_in and nf_damping:
            return "minimum_norm"
        if not nf_damping:
            return "simple"
        if self.linsolve.method in ("cholesky",):
            return "normal_form"
        return "least_squares"


@dataclasses.dataclass(frozen=True)
class Dogleg:
    newton: Any = None           # NewtonDescent | DampedNewtonDescent
    steepest: SteepestDescent = SteepestDescent()

    def __post_init__(self):
        if self.newton is None:
            object.__setattr__(self, "newton", NewtonDescent())


@dataclasses.dataclass(frozen=True)
class GeodesicAcceleration:
    descent: Any = None          # the inner descent (DampedNewton for LM)
    finite_diff_step: float = 0.1
    alpha: float = 0.75


@dataclasses.dataclass(frozen=True)
class DampedNewtonState:
    damping: Any                 # LM / SER damping state
    last_D: Any                  # damping term of the current system
    factors: Any = None          # SVD of the current stacked system

    def replace(self, **kw) -> "DampedNewtonState":
        return dataclasses.replace(self, **kw)


def descent_init(cfg, ctx: DescentCtx, J, fu, u):
    if isinstance(cfg, (NewtonDescent, SteepestDescent)):
        return None
    if isinstance(cfg, DampedNewtonDescent):
        dtype, dev = u.dtype, u.device
        mode = cfg.resolve_mode(ctx)
        if isinstance(cfg.damping, dmp.LevenbergMarquardtDamping):
            n = ctx.n_out if mode == "minimum_norm" else ctx.n_in
            dstate = dmp.lm_damping_init(cfg.damping, cfg.initial_damping, n,
                                         dtype, dev)
            last_D = torch.zeros((n,), dtype=dtype, device=dev)
        elif isinstance(cfg.damping, dmp.SwitchedEvolutionRelaxation):
            dstate = dmp.ser_damping_init(cfg.damping, cfg.initial_damping,
                                          fu, dtype)
            last_D = torch.zeros((), dtype=dtype, device=dev)
        else:
            raise ValueError(f"unknown damping {cfg.damping!r}")
        return DampedNewtonState(damping=dstate, last_D=last_D)
    if isinstance(cfg, Dogleg):
        return descent_init(cfg.newton, ctx, J, fu, u)
    if isinstance(cfg, GeodesicAcceleration):
        return descent_init(cfg.descent, ctx, J, fu, u)
    raise ValueError(f"unknown descent {cfg!r}")


def _matrix_precond(cfg: LinearSolver, J, verbosity=None):
    """Built-in preconditioners for materialized Jacobians.  'jacobi'
    scales by the diagonal (none for the matrix-free operator, as in the
    JAX package).  'device_lu' is the exact host-factored, device-applied
    sparse LU (``ops/device_lu.py``): one refresh a Newton linearization,
    then every Krylov iteration applies the factors on the device.  Where
    no plan applies (J not CSR, an unsupported schedule) it proceeds
    unpreconditioned, as the JAX package does, and says so through the
    linear ``precond_unavailable`` message class."""
    if cfg.precond == "device_lu":
        from ..ops.device_lu import device_lu_preconditioner
        from ..ops.sparse import CSR
        from .verbosity import NonlinearVerbosity

        def _notify(why):
            lin = (getattr(verbosity, "linear", None)
                   if isinstance(verbosity, NonlinearVerbosity)
                   else verbosity)
            if lin is not None and hasattr(lin, "emit"):
                lin.emit("precond_unavailable",
                         f"precond='device_lu' requested but {why}; "
                         "proceeding unpreconditioned")

        if not isinstance(J, CSR):
            _notify(f"the operator is {type(J).__name__}, not CSR")
            return None
        M = device_lu_preconditioner(J)
        if M is None:
            _notify("no device-LU plan applies to this pattern "
                    "(native lib missing or schedule unsupported)")
        return M
    if cfg.precond != "jacobi" or isinstance(J, StatefulJacobianOperator):
        return None
    diag = J.diagonal()
    safe = torch.where(diag == 0, torch.ones_like(diag), diag)
    return lambda x: x / safe


# LinearSolver.krylov_basis_dtype → the GMRES basis dtype (the JAX
# package's table; a name outside it raises KeyError there too)
_BASIS_DTYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16,
                 "f16": torch.float16}


def _krylov_solve(cfg: NewtonDescent, ctx: DescentCtx, J, fu,
                  krylov_rtol, u):
    """Krylov route: J δu = -fu with J a matrix-free operator, a sparse
    container or a dense matrix.  Returns ``(δu, ok, krylov_iterations,
    products)`` with ``ok`` a 0-d device bool and ``products`` the number
    of products with J."""
    from ..ops.krylov import solve_krylov
    from ..ops.sparse import CSR, DIA

    is_operator = isinstance(J, StatefulJacobianOperator)
    if isinstance(J, (CSR, DIA)) and u is not None and u.dim() > 1:
        raise NotImplementedError(
            "a sparse Jacobian with a Krylov solver needs a flat state "
            "(u0.reshape(-1), and a residual on flat vectors): on a state of "
            f"shape {tuple(u.shape)} the JAX package fails as well (ROADMAP "
            "C)")
    method = cfg.linsolve.method if cfg.linsolve.is_krylov else "gmres"
    rhs = fu
    if not ctx.square:
        # normal-form Krylov least squares, as the JAX package's:
        # JᵀJ δu = Jᵀfu (complex: Jᴴ) by lazy vjp∘jvp products
        base, rhs = _normal_form(J, fu, u)
    elif is_operator:
        base = J
    elif isinstance(J, CSR):
        base = J.matvec_fn()        # staged: any repack runs once per step
    else:
        base = as_matvec(J)
    products = [0]

    def matvec(v):
        products[0] += 1
        return base(v)

    npdt = real_np_dtype(fu.dtype)
    rtol = (krylov_rtol if krylov_rtol is not None
            else float(np.sqrt(np.finfo(npdt).eps)))
    if cfg.linsolve.precond_fn is not None:
        # Contract: precond_fn(u) -> (v -> M⁻¹v); a plain v -> M⁻¹v
        # callable (u-independent) is accepted too.  As in the JAX package,
        # the factory is always called first: a plain callable then returns
        # an array (one preconditioner application, wasted, per Newton step)
        # and is used itself.  The wasted call is kept so that the iterates
        # and stats match the JAX package's.  A factory marked
        # ``wants_residual`` is called as precond_fn(u, fu) and must return
        # the callable.
        if getattr(cfg.linsolve.precond_fn, "wants_residual", False):
            M = cfg.linsolve.precond_fn(u, fu)
            if not callable(M):
                raise TypeError(
                    "a wants_residual preconditioner factory must "
                    "return a v -> M⁻¹v callable from prep(u, fu); "
                    f"got {type(M).__name__}")
        else:
            M = cfg.linsolve.precond_fn(u)
            if not callable(M):
                M = cfg.linsolve.precond_fn
    else:
        M = _matrix_precond(cfg.linsolve, J, ctx.verbosity)
    kw = {}
    if method == "gmres" and cfg.linsolve.krylov_basis_dtype:
        kw["basis_dtype"] = _BASIS_DTYPES[cfg.linsolve.krylov_basis_dtype]
    res = solve_krylov(method, matvec, rhs, restart=cfg.linsolve.restart,
                       maxiter=cfg.linsolve.krylov_maxiter, rtol=rtol, M=M,
                       **kw)
    finite = torch.isfinite(res.x).all()
    from .verbosity import traced_emit_linear
    traced_emit_linear(
        ctx.verbosity, "krylov_unconverged", not res.success,
        "Krylov solve did not reach rtol (|r| = {rn} after {it} "
        "iterations)", rn=res.residual_norm, it=res.iterations)
    traced_emit_linear(
        ctx.verbosity, "krylov_breakdown", ~finite,
        "Krylov breakdown: non-finite iterate (|r| = {rn})",
        rn=res.residual_norm)
    return -res.x, finite, res.iterations, products[0]


def _normal_form(J, fu, u):
    """The normal-form operator v ↦ Jᵀ(J v) and right-hand side Jᵀfu
    (complex: Jᴴ) of a non-square J, on ``u``'s shape."""
    if isinstance(J, StatefulJacobianOperator):
        return StatefulJacobianNormalFormOperator(J.op, J.u), rmv(J, fu)
    from ..ops.sparse import CSR, DIA, ELL
    if isinstance(J, (CSR, DIA, ELL)):
        return (lambda v: J.rmatvec(J.matvec(v))), J.rmatvec(fu)
    Jh = J.mH if J.is_complex() else J.T
    shape = u.shape
    return ((lambda v: (Jh @ (J @ v.reshape(-1))).reshape(shape)),
            (Jh @ fu.reshape(-1)).reshape(shape))


def _newton_solve(cfg: NewtonDescent, ctx: DescentCtx, J, fu,
                  krylov_rtol=None, u=None):
    """J δu = -fu.  Returns ``(δu, ok, krylov_iterations, products)``."""
    from ..ops.sparse import CSR, DIA, ELL

    if cfg.linsolve.is_krylov or isinstance(J, StatefulJacobianOperator):
        return _krylov_solve(cfg, ctx, J, fu, krylov_rtol, u)
    if isinstance(J, (CSR, DIA, ELL)):
        if not ctx.square or isinstance(J, ELL):
            J = J.todense()          # an ELL or non-square J goes dense
        else:
            du, ok = _sparse_direct(cfg, J, fu.reshape(-1))
            if u is not None and u.dim() != 1:
                du = du.reshape(u.shape)
            return du, ok, 0, 0
    fu_flat = fu.reshape(-1)
    if ctx.square:
        x, ok = solve_dense(J, fu_flat, cfg.linsolve,
                            verbosity=ctx.verbosity)
    else:
        x = _lstsq(J, fu_flat)[0]
        ok = torch.isfinite(x).all()
    du = -x
    if u is not None and u.dim() != 1:
        du = du.reshape(u.shape)
    return du, ok, 0, 0


def _sparse_direct(cfg: NewtonDescent, J, fu_flat):
    """The sparse direct route (the KLU role): PCR, block cyclic reduction,
    the host AMD LU or BiCGStab by ``solve_sparse_direct``.  With
    ``method='sparse_lu_device'`` on a CSR J, the device-applied factor
    first: one refresh (the host refactorization), then the triangular
    sweeps on the device; a re-pivot falls back to the exact route for
    that step (the JAX package's ``lax.cond``, decided on the host).
    Returns ``(δu, ok)``."""
    from ..ops.direct_sparse import solve_sparse_direct
    from ..ops.sparse import CSR
    if isinstance(J, CSR) and cfg.linsolve.method == "sparse_lu_device":
        from ..ops.device_lu import device_lu_for
        lu = device_lu_for(J.indptr, J.indices, J.shape[0],
                           dtype=J.data.dtype)
        if lu is not None:
            x, ok = lu.solve(lu.refresh(J.data), fu_flat)
            if ok:
                return -x, torch.ones((), dtype=torch.bool,
                                      device=x.device)
    x, ok = solve_sparse_direct(J, fu_flat)
    return -x, ok


def _damped_system(cfg: DampedNewtonDescent, state: DampedNewtonState,
                   ctx: DescentCtx, J, fu, recompute_damping: bool):
    """The damping term D of the resolved mode; returns (D, state, mode)."""
    mode = cfg.resolve_mode(ctx)
    if not recompute_damping:
        return state.last_D, state, mode
    if isinstance(cfg.damping, dmp.LevenbergMarquardtDamping):
        if mode == "minimum_norm":
            D, dstate = dmp.lm_damping_update(cfg.damping, state.damping,
                                              J @ J.T, is_normal_form=True)
        elif mode == "normal_form":
            D, dstate = dmp.lm_damping_update(cfg.damping, state.damping,
                                              J.T @ J, is_normal_form=True)
        else:  # least_squares: the damping from J directly
            D, dstate = dmp.lm_damping_update(cfg.damping, state.damping, J,
                                              is_normal_form=False)
    else:  # SER
        D, dstate = dmp.ser_damping_update(cfg.damping, state.damping, fu)
    return D, DampedNewtonState(damping=dstate, last_D=D), mode


def _damped_solve(cfg: DampedNewtonDescent, mode: str, J, fu, D,
                  factors=None):
    """Solve the damped system; returns ``(δu, ok, factors)`` (``factors``:
    the SVD of the stacked system, which a second right-hand side on the
    same system reuses)."""
    if mode == "simple":
        M = getattr(cfg.damping, "mass_matrix", None)
        if M is None:
            A = J + D * torch.eye(J.shape[0], J.shape[1], dtype=J.dtype,
                                  device=J.device)
        else:
            M = torch.as_tensor(M, dtype=J.dtype, device=J.device)
            # a diagonal vector or a full matrix: (J + D·M) δu = -F
            A = J + D * (torch.diag(M) if M.dim() == 1 else M)
        x, ok = solve_dense(A, fu, cfg.linsolve)
        return -x, ok, None
    if mode == "least_squares":
        # [J; √D] δu ≈ [-fu; 0]
        sqrtD = torch.sqrt(ordering.maximum(D, 0.0) if D.is_complex()
                           else torch.clamp(D, min=0.0))
        A = torch.cat([J, torch.diag(sqrtD)], dim=0)
        b = torch.cat([fu, torch.zeros((J.shape[1],), dtype=fu.dtype,
                                       device=fu.device)])
        x, factors = _lstsq(A, b, factors)
        return -x, torch.isfinite(x).all(), factors
    if mode == "normal_form":
        A = J.T @ J + torch.diag(D)
        x, ok = solve_spd(A, J.T @ fu)
        return -x, ok, None
    if mode == "minimum_norm":
        # (JJᵀ + λD̃) z = -fu; δu = Jᵀ z
        A = J @ J.T + torch.diag(D)
        z, ok = solve_spd(A, fu)
        return -(J.T @ z), ok, None
    raise AssertionError(mode)


def descent_solve(cfg, state, ctx: DescentCtx, J, fu, u, trust_region=None,
                  recompute_damping: bool = True, krylov_rtol=None):
    """Compute δu.  Returns (DescentResult, new_state)."""
    if isinstance(cfg, NewtonDescent):
        du, ok, iters, products = _newton_solve(cfg, ctx, J, fu,
                                                krylov_rtol, u)
        return DescentResult(du=du, success=ok, linsolve_success=ok,
                             duJtJdu=_nan_like(du), krylov_iters=iters,
                             njvp=products), state

    if isinstance(cfg, SteepestDescent):
        return _ok_result(-rmv(J, fu), nsolve=0, nfactors=0), state

    if isinstance(cfg, DampedNewtonDescent):
        from ..ops.sparse import CSR, DIA, ELL
        if isinstance(J, (CSR, DIA, ELL)):
            J = J.todense()
        fu_l = fu.reshape(-1)
        D, state, mode = _damped_system(cfg, state, ctx, J, fu_l,
                                        recompute_damping)
        reuse = state.factors if not recompute_damping else None
        du, ok, factors = _damped_solve(cfg, mode, J, fu_l, D, reuse)
        state = state.replace(factors=factors)
        if u.dim() != 1:
            du = du.reshape(u.shape)
        return DescentResult(du=du, success=ok, linsolve_success=ok,
                             duJtJdu=_nan_like(du)), state

    if isinstance(cfg, Dogleg):
        return _dogleg_solve(cfg, state, ctx, J, fu, u, trust_region)

    if isinstance(cfg, GeodesicAcceleration):
        return _geodesic_solve(cfg, state, ctx, J, fu, u, trust_region)

    raise ValueError(f"unknown descent {cfg!r}")


def _dogleg_solve(cfg: Dogleg, state, ctx: DescentCtx, J, fu, u,
                  trust_region):
    """The dogleg step for the trust radius ``trust_region`` (a host
    scalar, complex on a complex state, compared in JAX's order); the
    branch is chosen on the device."""
    assert trust_region is not None, "Dogleg requires a trust region radius"
    res_newton, state = descent_solve(cfg.newton, state, ctx, J, fu, u)
    du_newton = res_newton.du
    nan = _nan_like(du_newton)
    tr = (complex(trust_region) if np.iscomplexobj(trust_region)
          else float(trust_region))

    # the Cauchy (steepest-descent) point, along −Jᵀfu unconjugated on a
    # complex state, as the JAX package steps
    du_cauchy = -rmv_t(J, fu)
    l_grad = l2_norm(du_cauchy)
    J_dc = mv(J, du_cauchy)
    duJtJdu = tree_dot(J_dc, J_dc)
    d_cauchy = (l_grad * (l_grad * l_grad)) / duJtJdu

    # 1: Newton inside the trust region
    newton_inside = ordering.less(l2_norm(du_newton), tr, or_equal=True)
    # 2: the Cauchy point outside — the steepest direction to the radius
    lam = tr / l_grad
    du_clipped = lam * du_cauchy
    # 3: the dogleg between the Cauchy point and the Newton step
    du1 = (d_cauchy / l_grad) * du_cauchy
    du2 = du_newton - du1
    a = tree_dot(du2, du2)
    b = 2.0 * tree_dot(du1, du2)
    c = d_cauchy * d_cauchy - tr * tr
    aux = b * b - 4.0 * a * c
    aux = (ordering.maximum(aux, 0.0) if aux.is_complex()
           else torch.clamp(aux, min=0.0))
    tau = (-b + torch.sqrt(aux)) / (2.0 * a)
    du_interp = torch.addcmul(du1, tau, du2)     # fused, as XLA's

    outside = ordering.greater(d_cauchy, tr, or_equal=True)
    du = torch.where(newton_inside, du_newton,
                     torch.where(outside, du_clipped, du_interp))
    extra = torch.where(newton_inside, nan,
                        torch.where(outside, lam * lam * duJtJdu, nan))
    ok = res_newton.linsolve_success
    return DescentResult(du=du, success=ok, linsolve_success=ok,
                         duJtJdu=extra, nsolve=res_newton.nsolve,
                         nfactors=res_newton.nfactors), state


def _geodesic_solve(cfg: GeodesicAcceleration, state, ctx: DescentCtx, J, fu,
                    u, trust_region):
    """The geodesic-accelerated step: velocity v, acceleration a from a
    second solve on the same damped system, accepted (on the device) when
    2‖a‖ ≤ α‖v‖."""
    h = cfg.finite_diff_step
    res_v, state = descent_solve(cfg.descent, state, ctx, J, fu, u,
                                 trust_region=trust_region,
                                 recompute_damping=True)
    v = res_v.du
    fu2 = ctx.f_flat(torch.add(u, v, alpha=h))     # fused, as XLA's
    Jv = mv(J, v)
    rhs = (2.0 / h) * ((fu2 - fu) / h - Jv)
    res_a, state = descent_solve(cfg.descent, state, ctx, J, rhs, u,
                                 trust_region=trust_region,
                                 recompute_damping=False)
    a = res_a.du
    accepted = 2.0 * l2_norm(a) <= cfg.alpha * l2_norm(v)
    du = torch.where(accepted, v + a / 2.0, v)
    ok = res_v.linsolve_success & res_a.linsolve_success
    return DescentResult(du=du, success=accepted & ok, linsolve_success=ok,
                         duJtJdu=_nan_like(du), v=v,
                         nf=res_v.nf + res_a.nf + 1,
                         nsolve=res_v.nsolve + res_a.nsolve,
                         nfactors=res_v.nfactors), state


def descent_post_step(cfg, state, accepted: bool):
    """End-of-step hook: LM's λ update (``accepted``: a host bool)."""
    if isinstance(cfg, DampedNewtonDescent):
        if isinstance(cfg.damping, dmp.LevenbergMarquardtDamping):
            return state.replace(damping=dmp.lm_damping_post_step(
                cfg.damping, state.damping, accepted))
        return state
    if isinstance(cfg, GeodesicAcceleration):
        return descent_post_step(cfg.descent, state, accepted)
    if isinstance(cfg, Dogleg):
        return descent_post_step(cfg.newton, state, accepted)
    return state

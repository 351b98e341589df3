"""The first-order and quasi-Newton engines and their ladders on a batch
of trajectories (ROADMAP A.29): ``NewtonRaphson`` (with or without
``BackTracking``), ``TrustRegion`` under the simple and Fan radius
schemes, ``LevenbergMarquardt``, each on a dense Jacobian; ``Broyden``
and ``Klement`` with their reset rules; and polyalgorithms whose rungs
are all of these (the default ladder ``FastShortcutNonlinearPolyalg``
among them).

The lone engines (``first_order.py``, ``quasi_newton.py``) read their
decisions to the host each step: the descent's success, the trust region's ratio and radius, the
termination norms, the reset rules' flags.  Here the state is (B, n),
one row a trajectory, and every value a lone engine keeps per solve is a
(B,) tensor: a decision
is a ``torch.where`` on the device, a row that has stopped keeps its carry
(``core/lockstep.py`` ``select_rows``), and the loop reads one flag a step
(is any row still running?), BackTracking one a trial and a ladder one a
rung (which rows failed).  The residual and the Jacobians are the simple
tier's (``solvers/simple.py`` ``BatchedResidual``), the square solves
``solve_dense_batched`` and the termination checks
``check_termination_batched``.

Each row rounds as its lone solve does: a lone engine's host arithmetic
(numpy scalars of the working dtype) is taken here in the same order on
(B,) tensors.  Three operations need care: matrix-vector products
(``rows_matvec``), the Fan scheme's power (``pow_as_host``), and a host
scalar divided by a device norm, which torch computes as
``reciprocal(norm) · scalar`` and the batch repeats.  The dense rank-
deficient fallback is computed for every row and selected (the JAX
package's ``lax.cond`` under ``vmap``); it rounds as the lone fallback up
to its products.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .. import _backend
from ..core import descent as dsc
from ..core import termination as trm
from ..core import trust_region as trg
from ..core.damping import LevenbergMarquardtDamping
from ..core.linesearch import BackTracking
from ..core.lockstep import (any_row, pow_as_host, row_flags, rows_dot,
                             rows_matvec, rows_vecmat, select_rows)
from ..core.returncode import ReturnCode
from ..core.solution import NLStats, _SUCCESSFUL
from ..ops.linear_solve import (_batched_ridge_fallback, _lstsq,
                                solve_dense_batched)
from .first_order import GeneralizedFirstOrderAlgorithm
from .polyalg import NonlinearSolvePolyAlgorithm
from .quasi_newton import (IllConditionedJacobianReset, NoChangeInStateReset,
                           QuasiNewtonAlgorithm)

_DENSE_METHODS = ("auto", "lu", "qr")
_TR_SCHEMES = ("simple", "fan")


def _l2(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _dot(a, b):
    return (a * b).sum(-1)


def _col(x):
    return x[:, None]


# ---------------------------------------------------------------------------
# what the batch takes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Plan:
    """An engine's parts, as the batch runs them."""

    kind: str                       # "newton" | "dogleg" | "damped"
    method: str                     # the square solve: "lu" | "qr"
    linesearch: Optional[BackTracking] = None
    trustregion: Any = None         # GenericTrustRegionScheme | LM's
    damped: Optional[dsc.DampedNewtonDescent] = None
    geodesic: Optional[dsc.GeodesicAcceleration] = None
    max_shrink_times: int = 32


def _dense_method(linsolve) -> Optional[str]:
    if (linsolve.method not in _DENSE_METHODS or linsolve.precond != "none"
            or linsolve.precond_fn is not None):
        return None
    return "qr" if linsolve.method == "qr" else "lu"


def plan_of(alg) -> Optional[_Plan]:
    """The batch's plan of a first-order algorithm, or None when the
    lockstep batch does not take it (it then solves trajectory by
    trajectory)."""
    if not isinstance(alg, GeneralizedFirstOrderAlgorithm):
        return None
    pol = alg.jacobian
    if (pol.mode not in ("auto", "forward") or pol.chunk_size is not None
            or alg.forcing is not None):
        return None
    ls = alg.linesearch
    if ls is not None and type(ls) is not BackTracking:
        return None
    tr, d = alg.trustregion, alg.descent
    if isinstance(d, dsc.NewtonDescent) and tr is None:
        method = _dense_method(d.linsolve)
        return None if method is None else _Plan("newton", method, ls)
    if ls is not None:
        return None
    if (isinstance(d, dsc.Dogleg) and type(d.newton) is dsc.NewtonDescent
            and isinstance(tr, trg.GenericTrustRegionScheme)
            and tr.method in _TR_SCHEMES):
        method = _dense_method(d.newton.linsolve)
        return None if method is None else _Plan(
            "dogleg", method, trustregion=tr,
            max_shrink_times=alg.max_shrink_times)
    geo = d if isinstance(d, dsc.GeodesicAcceleration) else None
    damped = geo.descent if geo is not None else d
    if (isinstance(damped, dsc.DampedNewtonDescent)
            and isinstance(damped.damping, LevenbergMarquardtDamping)
            and damped.mode == "auto"
            and damped.linsolve.method != "cholesky"
            and isinstance(tr, trg.LevenbergMarquardtTrustRegion)):
        return _Plan("damped", "lu", trustregion=tr, damped=damped,
                     geodesic=geo)
    return None


@dataclasses.dataclass(frozen=True)
class _QNPlan:
    """A quasi-Newton engine's parts, as the batch runs them: Broyden (the
    inverse Jacobian, full) under ``NoChangeInStateReset`` or Klement (the
    diagonal Jacobian) under ``IllConditionedJacobianReset``, each from
    αI, with no line search or trust region."""

    rule: str                       # good_broyden | bad_broyden | klement
    reset: Any
    max_resets: int
    alpha: Optional[float]


def qn_plan_of(alg) -> Optional[_QNPlan]:
    """The batch's plan of a quasi-Newton algorithm, or None."""
    if (not isinstance(alg, QuasiNewtonAlgorithm)
            or alg.linesearch is not None or alg.trustregion is not None
            or alg.init_jacobian != "identity"):
        return None
    rule = alg.reinit_rule
    if (alg.update_rule in ("good_broyden", "bad_broyden")
            and alg.structure == "full"
            and type(rule) is NoChangeInStateReset):
        return _QNPlan(alg.update_rule, rule, alg.max_resets, alg.alpha)
    if (alg.update_rule == "klement" and alg.structure == "diagonal"
            and type(rule) is IllConditionedJacobianReset):
        return _QNPlan("klement", rule, alg.max_resets, alg.alpha)
    return None


def lockstep_supported(alg) -> bool:
    """True when ``solve_ensemble`` runs ``alg`` as one lockstep batch:
    the engines of ``plan_of`` and ``qn_plan_of``, or a polyalgorithm
    whose rungs from its ``start_index`` on are all such engines (the
    default ladder among them)."""
    if isinstance(alg, NonlinearSolvePolyAlgorithm):
        rungs = alg.algs[alg.start_index - 1:]
        return bool(rungs) and all(lockstep_supported(a) for a in rungs)
    return plan_of(alg) is not None or qn_plan_of(alg) is not None


# ---------------------------------------------------------------------------
# the carry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TRRows:
    """``trust_region.TRState`` with one row a trajectory."""

    radius: torch.Tensor
    max_radius: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    p4: torch.Tensor
    shrink_counter: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LMTRRows:
    """``trust_region.LMTRState`` with one row a trajectory."""

    loss_old: torch.Tensor
    v_cache: torch.Tensor
    norm_v_old: torch.Tensor


@dataclasses.dataclass(frozen=True)
class LockCarry:
    """``first_order.FOCarry`` with one row a trajectory: ``u``, ``fu``
    (B, ·); ``nsteps``, ``force_stop``, ``retcode`` (B,); ``stats`` an
    ``NLStats`` of (B,) tensors; LM's λ (B,) and running max of diag(JᵀJ)
    (B, n); the trust region's rows."""

    u: Any
    fu: Any
    nsteps: Any
    force_stop: Any
    retcode: Any
    stats: Any
    term: Any
    lam: Any = None
    DtD: Any = None
    tr: Any = None

    def replace(self, **kw) -> "LockCarry":
        return dataclasses.replace(self, **kw)


def _tr_init(cfg, X, FX):
    """``trust_region.tr_init`` on every row."""
    if isinstance(cfg, trg.LevenbergMarquardtTrustRegion):
        inf = torch.full((X.shape[0],), float("inf"), dtype=X.dtype,
                         device=X.device)
        return LMTRRows(loss_old=inf, v_cache=X, norm_v_old=inf)
    fu_norm = _l2(FX)
    full = lambda v: torch.full_like(fu_norm, v)    # noqa: E731
    if cfg.max_trust_radius is not None:
        mtr = full(cfg.max_trust_radius)
    elif cfg.method == "simple":
        mtr = torch.maximum(fu_norm, X.amax(-1) - X.amin(-1))
    else:
        mtr = full(float("inf"))
    if cfg.initial_trust_radius is not None:
        itr = full(cfg.initial_trust_radius)
    elif cfg.method == "fan":
        itr = pow_as_host(fu_norm, 0.99) / 10.0
    else:
        itr = mtr / 11.0
    p1, p2, p3, p4 = (full(p) for p in cfg.parameters())
    return TRRows(radius=itr, max_radius=mtr, p1=p1, p2=p2, p3=p3, p4=p4,
                  shrink_counter=torch.zeros(X.shape[0], dtype=torch.int32,
                                             device=X.device))


def _init(plan: _Plan, res, term_cfg, X0, reltol) -> LockCarry:
    B, dev = X0.shape[0], X0.device
    FX0 = res(X0)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    lam = DtD = None
    if plan.damped is not None:
        lam = torch.full((B,), plan.damped.initial_damping, dtype=X0.dtype,
                         device=dev)
        DtD = torch.full_like(X0, plan.damped.damping.min_damping)
    return LockCarry(
        u=X0, fu=FX0, nsteps=zeros,
        force_stop=torch.zeros(B, dtype=torch.bool, device=dev),
        retcode=torch.full_like(zeros, int(ReturnCode.Default)),
        stats=NLStats(zeros, zeros, zeros, zeros, zeros).incr(nf=1),
        term=trm.init_termination_batched(term_cfg, FX0, X0, reltol),
        lam=lam, DtD=DtD,
        tr=(None if plan.trustregion is None
            else _tr_init(plan.trustregion, X0, FX0)))


# ---------------------------------------------------------------------------
# descents
# ---------------------------------------------------------------------------

def _square_solve(J, fu, method):
    """``solve_dense(J[i], fu[i], LinearSolver(method))`` of every row,
    the ridge fallback taken where the primary result is not finite on
    finite inputs.  Returns ``(x, ok)``."""
    if method == "lu":
        return solve_dense_batched(J, fu)
    q, r = torch.linalg.qr(J)
    x = torch.linalg.solve_triangular(
        r, rows_matvec(q.mT, fu)[..., None], upper=True)[..., 0]
    finite_in = (torch.isfinite(J).flatten(-2).all(-1)
                 & torch.isfinite(fu).all(-1))
    want = ~torch.isfinite(x).all(-1) & finite_in
    x = torch.where(_col(want), _batched_ridge_fallback(J, fu), x)
    return x, torch.isfinite(x).all(-1)


def _dogleg(J, fu, du_newton, tr):
    """``descent._dogleg_solve`` on every row, for the radii ``tr`` (B,).
    Returns ``(du, duJtJdu)``."""
    du_cauchy = -rows_matvec(J.mT, fu)
    l_grad = _l2(du_cauchy)
    J_dc = rows_matvec(J, du_cauchy)
    duJtJdu = _dot(J_dc, J_dc)
    d_cauchy = (l_grad * (l_grad * l_grad)) / duJtJdu
    newton_inside = _l2(du_newton) <= tr
    lam = torch.reciprocal(l_grad) * tr          # the lone `tr / l_grad`
    du_clipped = _col(lam) * du_cauchy
    du1 = _col(d_cauchy / l_grad) * du_cauchy
    du2 = du_newton - du1
    a = _dot(du2, du2)
    b = 2.0 * _dot(du1, du2)
    c = d_cauchy * d_cauchy - tr * tr
    aux = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    tau = (-b + torch.sqrt(aux)) / (2.0 * a)
    du_interp = torch.addcmul(du1, _col(tau), du2)
    outside = d_cauchy >= tr
    du = torch.where(_col(newton_inside), du_newton,
                     torch.where(_col(outside), du_clipped, du_interp))
    nan = torch.full_like(tr, float("nan"))
    extra = torch.where(newton_inside, nan,
                        torch.where(outside, lam * lam * duJtJdu, nan))
    return du, extra


def _damped_lstsq(J, rhs, D, factors):
    """``descent._damped_solve`` in the least-squares mode on every row:
    [J; √D] δu ≈ [-rhs; 0].  Returns ``(δu, ok, factors)``."""
    sqrtD = torch.sqrt(torch.clamp(D, min=0.0))
    A = torch.cat([J, torch.diag_embed(sqrtD)], dim=-2)
    b = torch.cat([rhs, torch.zeros_like(D)], dim=-1)
    x, factors = _lstsq(A, b, factors, matvec=rows_matvec)
    return -x, torch.isfinite(x).all(-1), factors


@dataclasses.dataclass
class _Descent:
    du: Any
    success: Any
    linsolve_ok: Any
    duJtJdu: Any = None
    v: Any = None
    DtD: Any = None
    nf: int = 0
    nsolve: int = 1


def _descent(plan: _Plan, res, c: LockCarry, J) -> _Descent:
    u, fu = c.u, c.fu
    if plan.kind != "damped":
        x, ok = _square_solve(J, fu, plan.method)
        if plan.kind == "newton":
            return _Descent(-x, ok, ok)
        du, extra = _dogleg(J, fu, -x, c.tr.radius)
        return _Descent(du, ok, ok, duJtJdu=extra)
    # LM: λ·max(DᵀD, diag(JᵀJ)), then the stacked least squares
    DtD = torch.maximum(c.DtD, (J * J).sum(-2))
    D = _col(c.lam) * DtD
    v, ok_v, factors = _damped_lstsq(J, fu, D, None)
    geo = plan.geodesic
    if geo is None:
        return _Descent(v, ok_v, ok_v, DtD=DtD)
    h = geo.finite_diff_step
    fu2 = res(torch.add(u, v, alpha=h))
    rhs = (2.0 / h) * ((fu2 - fu) / h - rows_matvec(J, v))
    a, ok_a, _ = _damped_lstsq(J, rhs, D, factors)
    accepted = 2.0 * _l2(a) <= geo.alpha * _l2(v)
    ok = ok_v & ok_a
    return _Descent(torch.where(_col(accepted), v + a / 2.0, v),
                    accepted & ok, ok, v=v, DtD=DtD, nf=1, nsolve=2)


# ---------------------------------------------------------------------------
# globalization
# ---------------------------------------------------------------------------

def _backtracking(cfg: BackTracking, res, J, u, du, fu, active):
    """``linesearch._backtracking`` on every row: each row whose trial is
    pending takes the next trial together; a row that has accepted stops.
    Returns ``(alpha, success, nf)``, (B,) tensors; one read a trial."""
    def merit(alpha):
        f = res(torch.addcmul(u, _col(alpha), du))
        return 0.5 * _dot(f, f)

    slope = _dot(fu, rows_matvec(J, du))
    phi0 = 0.5 * _dot(fu, fu)
    alpha = torch.full_like(phi0, cfg.initial_alpha)
    phival = merit(alpha)

    def armijo(alpha, phival):
        return phival <= phi0 + cfg.c_1 * alpha * slope

    it = torch.zeros(u.shape[0], dtype=torch.int32, device=u.device)
    done = torch.zeros_like(active)
    while True:
        want = ~done & (it < cfg.maxiters) & active
        if not any_row(want):
            break
        it = it + want.to(it.dtype)
        ok = armijo(alpha, phival)
        done = done | (want & ok)
        trial = want & ~ok
        # the quadratic interpolation minimizer, clipped to [ρ_lo, ρ_hi]·α
        denom = 2.0 * (phival - phi0 - alpha * slope)
        alpha_q = -slope * alpha * alpha / torch.where(
            denom != 0, denom, torch.ones_like(denom))
        alpha_new = torch.minimum(torch.maximum(alpha_q, cfg.rho_lo * alpha),
                                  cfg.rho_hi * alpha)
        alpha_new = torch.where(torch.isfinite(alpha_new), alpha_new,
                                cfg.rho_hi * alpha)
        alpha = torch.where(trial, alpha_new, alpha)
        phival = torch.where(trial, merit(alpha), phival)
    success = (armijo(alpha, phival) & torch.isfinite(alpha)
               & torch.isfinite(phival))
    return alpha, success, it + 1


def _tr_update(cfg, st: TRRows, fn_new, fn, du_jtfu, duJtJdu, du_norm):
    """``trust_region.tr_update`` (simple and Fan) on every row: returns
    ``(accepted, new rows)``."""
    num = (fn_new * fn_new - fn * fn) / 2.0
    rho = num / (du_jtfu + duJtJdu / 2.0)
    stt = cfg.resolved_step_threshold()
    sht = cfg.resolved_shrink_threshold()
    et = cfg.resolved_expand_threshold()
    shf = cfg.resolved_shrink_factor()
    ef = cfg.resolved_expand_factor()
    accepted = rho > stt
    shrink = rho < sht
    counter = torch.where(shrink, st.shrink_counter + 1,
                          torch.zeros_like(st.shrink_counter))
    p1 = st.p1
    if cfg.method == "simple":
        tr = torch.where(shrink, st.radius * shf,
                         torch.where((rho > et) & (rho > stt),
                                     ef * st.radius, st.radius))
    else:   # fan
        p1 = torch.where(shrink, p1 * st.p2,
                         torch.where(rho > et,
                                     torch.minimum(p1 * st.p3, st.p4), p1))
        tr = p1 * pow_as_host(fn_new, 0.99)
    tr = torch.minimum(tr, st.max_radius)
    return accepted, dataclasses.replace(st, radius=tr, p1=p1,
                                         shrink_counter=counter)


def _lm_tr_update(cfg, st: LMTRRows, v, fu_new):
    """``trust_region._lm_tr_update`` on every row: the b_uphill accept
    rule."""
    norm_v = _l2(v)
    loss = _l2(fu_new)
    beta = _dot(v, st.v_cache) / (norm_v * st.norm_v_old)
    beta = torch.where(torch.isfinite(beta), beta, torch.zeros_like(beta))
    uphill = 1.0 - beta
    if cfg.b_uphill != 1.0:
        uphill = pow_as_host(uphill, cfg.b_uphill)
    accepted = uphill * loss <= st.loss_old
    new = LMTRRows(loss_old=loss, v_cache=v, norm_v_old=norm_v)
    return accepted, select_rows(accepted, new, st)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def _step(plan: _Plan, res, term_cfg, c: LockCarry, abstol, reltol,
          active) -> LockCarry:
    """One iteration of every row (``first_order.step_first_order``)."""
    u, fu = c.u, c.fu
    B = u.shape[0]
    J = res.jac(u)
    d = _descent(plan, res, c, J)
    stats = c.stats.incr(njacs=1, nsteps=1).incr(
        nf=d.nf, nsolve=d.nsolve, nfactors=1)
    false = torch.zeros(B, dtype=torch.bool, device=u.device)
    ls_failed = shrink_exceeded = false
    accepted = ~false
    tr = c.tr
    if plan.linesearch is not None:
        alpha, ls_ok, ls_nf = _backtracking(plan.linesearch, res, J, u,
                                            d.du, fu, active)
        ls_failed = ~ls_ok
        u_new = torch.addcmul(u, _col(alpha), d.du)
        fu_new = res(u_new)
        stats = stats.incr(nf=ls_nf + 1)
    else:
        u_new = u + d.du
        fu_new = res(u_new)
        stats = stats.incr(nf=1)
        if plan.kind == "dogleg":
            Jdu = rows_matvec(J, d.du)
            duJtJdu = torch.where(torch.isnan(d.duJtJdu), _dot(Jdu, Jdu),
                                  d.duJtJdu)
            accepted, tr = _tr_update(
                plan.trustregion, tr, _l2(fu_new), _l2(fu),
                _dot(d.du, rows_matvec(J.mT, fu)), duJtJdu, _l2(d.du))
            shrink_exceeded = tr.shrink_counter > plan.max_shrink_times
        elif plan.kind == "damped":
            accepted, tr = _lm_tr_update(
                plan.trustregion, tr, d.v if d.v is not None else d.du,
                fu_new)
        if plan.kind != "newton":
            # a rejected step keeps the old iterate (the check sees it)
            u_new = torch.where(_col(accepted), u_new, u)
            fu_new = torch.where(_col(accepted), fu_new, fu)

    # keep the old iterate when the descent was rejected; the termination
    # check counts only when it succeeded
    descent_ok = d.success & d.linsolve_ok
    u_new = torch.where(_col(descent_ok), u_new, u)
    fu_new = torch.where(_col(descent_ok), fu_new, fu)
    stop, term = trm.check_termination_batched(
        term_cfg, c.term, fu_new, u_new, u, abstol, reltol,
        is_least_squares=res.is_least_squares)
    stop = stop & descent_ok
    term = select_rows(descent_ok, term, c.term)

    lam = c.lam
    if plan.damped is not None:
        cfg = plan.damped.damping
        lam = lam * torch.where(accepted & d.success,
                                torch.full_like(lam,
                                                1.0 / cfg.decrease_factor),
                                torch.full_like(lam, cfg.increase_factor))

    # retcode priority: termination wins over a line-search failure or the
    # shrink limit; a linear-solve failure wins over everything
    code = lambda rc: torch.full_like(c.retcode, int(rc))  # noqa: E731
    retcode = torch.where(shrink_exceeded,
                          code(ReturnCode.ShrinkThresholdExceeded),
                          code(ReturnCode.Default))
    retcode = torch.where(ls_failed, code(ReturnCode.InternalLineSearchFailed),
                          retcode)
    retcode = torch.where(stop, term.retcode.to(retcode.dtype), retcode)
    retcode = torch.where(d.linsolve_ok, retcode,
                          code(ReturnCode.InternalLinearSolveFailed))
    return LockCarry(
        u=u_new, fu=fu_new, nsteps=c.nsteps + 1,
        force_stop=stop | ls_failed | shrink_exceeded | ~d.linsolve_ok,
        retcode=retcode, stats=stats, term=term, lam=lam,
        DtD=d.DtD if d.DtD is not None else c.DtD, tr=tr)


def run_first_order_lockstep(alg, res, term_cfg, X0, abstol, reltol,
                             maxiters: int) -> LockCarry:
    """Run the first-order ``alg`` on every row of ``X0`` (B, n) in
    lockstep; the final carry's ``u`` is each row's result (the retained
    best iterate under a safe-best mode, with ``fu`` re-evaluated
    there)."""
    plan = plan_of(alg)
    if plan is None:
        raise ValueError(f"{getattr(alg, 'name', alg)!r} does not run as a "
                         f"lockstep batch (lockstep_supported)")
    c = _init(plan, res, term_cfg, X0, reltol)
    while True:
        active = ~c.force_stop & (c.nsteps < maxiters)
        some, every = row_flags(active)
        if not some:
            break
        new = _step(plan, res, term_cfg, c, abstol, reltol, active)
        c = new if every else select_rows(active, new, c)
    return _finish(c, res, term_cfg, maxiters)


def _finish(c, res, term_cfg, maxiters: int):
    """Default → MaxIters or Success; then the safe-best iterate with f
    re-evaluated at it (``first_order.finalize_first_order``)."""
    retcode = torch.where(
        c.retcode == int(ReturnCode.Default),
        torch.where(c.nsteps >= maxiters, int(ReturnCode.MaxIters),
                    int(ReturnCode.Success)).to(c.retcode.dtype),
        c.retcode)
    if term_cfg.keeps_best:
        u = c.term.best_u
        return c.replace(u=u, fu=res(u), retcode=retcode,
                         stats=c.stats.incr(nf=1))
    return c.replace(retcode=retcode)


# ---------------------------------------------------------------------------
# the quasi-Newton engines (quasi_newton.py), Broyden and Klement
# ---------------------------------------------------------------------------

_EPS_GUARD = 1e-5


@dataclasses.dataclass(frozen=True)
class QNLockCarry:
    """``quasi_newton.QNCarry`` with one row a trajectory: the stored
    Jacobian ``J`` (B, n, n) (Broyden's inverse) or (B, n) (Klement's
    diagonal); the reset counters and the reset rule's state; ``flags``
    the next reset check's flags, a tuple of (B,) bools."""

    u: Any
    fu: Any
    nsteps: Any
    force_stop: Any
    retcode: Any
    stats: Any
    term: Any
    J: Any
    nresets: Any
    since_reset: Any
    force_reinit: Any
    update_fu_prev: Any
    s_du: Any
    s_dfu: Any
    flags: Any

    def replace(self, **kw) -> "QNLockCarry":
        return dataclasses.replace(self, **kw)


def _qn_init_J(plan: _QNPlan, u, fu):
    """``quasi_newton._init_J`` from αI on every row."""
    if plan.alpha is not None:
        alpha = torch.full((u.shape[0],), plan.alpha, dtype=u.dtype,
                           device=u.device)
    else:
        fu_norm = _l2(fu)
        alpha = torch.where(fu_norm < 1e-5, torch.ones_like(fu_norm),
                            2.0 * fu_norm / torch.clamp(_l2(u), min=1.0))
    n = u.shape[1]
    if plan.rule == "klement":
        return _col(alpha).expand(-1, n).clone()
    scale = torch.reciprocal(alpha)           # the lone `1.0 / alpha`
    eye = torch.eye(n, dtype=u.dtype, device=u.device)
    return scale[:, None, None] * eye


def _qn_reset_tol(plan: _QNPlan, dtype):
    if plan.reset.reset_tolerance is not None:
        return plan.reset.reset_tolerance
    return float(torch.finfo(dtype).eps) ** 0.75


def _qn_reset_flags(plan: _QNPlan, J, fu, dfu_prev, du):
    """``quasi_newton._reset_reads`` on every row."""
    if plan.rule == "klement":
        return ((J == 0).any(-1),)
    tol = _qn_reset_tol(plan, fu.dtype)
    out = ()
    if plan.reset.check_du:
        out += ((du.abs() <= tol).any(-1),)
    if plan.reset.check_dfu:
        out += (((fu - dfu_prev).abs() <= tol).any(-1),)
    return out


def _qn_reset_decide(plan: _QNPlan, c: QNLockCarry):
    """``quasi_newton._reset_decide`` on every row: ``(reset, s_du,
    s_dfu)``."""
    if plan.rule == "klement":
        return c.flags[0], c.s_du, c.s_dfu
    rule = plan.reset
    zero = torch.zeros_like(c.s_du)
    s_du, s_dfu = c.s_du, c.s_dfu
    reset = torch.zeros_like(c.force_stop)
    at = 0
    if rule.check_du:
        small = c.flags[at]
        at += 1
        s_du = torch.where(small, s_du + 1, zero)
        s_dfu = torch.where(small, s_dfu, zero)
        reset = reset | (small & (s_du >= rule.nsteps))
    if rule.check_dfu:
        small_f = c.flags[at]
        s_dfu = torch.where(small_f, s_dfu + 1, zero)
        s_du = torch.where(small_f | reset, s_du, zero)
        reset = reset | (small_f & (s_dfu >= rule.nsteps))
    return (reset, torch.where(reset, zero, s_du),
            torch.where(reset, zero, s_dfu))


def _qn_descent(plan: _QNPlan, J, fu):
    """``quasi_newton._qn_descent``: ``(δu, ok)`` of every row."""
    if plan.rule == "klement":
        safe = torch.where(J == 0, torch.ones_like(J), J)
        du = -(fu / safe)
        return du, (J != 0).all(-1) & torch.isfinite(du).all(-1)
    du = -rows_matvec(J, fu)
    return du, torch.isfinite(du).all(-1)


def _qn_update(plan: _QNPlan, J, fu, fu_prev, du):
    """``quasi_newton._update_jacobian`` on every row."""
    guard = lambda d: torch.where(d == 0, torch.full_like(  # noqa: E731
        d, _EPS_GUARD), d)
    dfu = fu - fu_prev
    if plan.rule == "klement":
        d = J
        Jdu = guard(d * d * du * du)
        q = torch.addcmul(dfu, d, du, value=-1.0) / Jdu
        return torch.addcmul(d, q * du * d, d)
    Jdfu = rows_matvec(J, dfu)
    if plan.rule == "good_broyden":
        denom = rows_dot(du, Jdfu)
        row = rows_vecmat(du, J)
    else:
        denom = _l2(dfu) ** 2
        row = dfu
    return torch.addcmul(J, ((du - Jdfu) / _col(guard(denom)))[:, :, None],
                         row[:, None, :])


def _qn_init(plan: _QNPlan, res, term_cfg, X0, reltol) -> QNLockCarry:
    B, dev = X0.shape[0], X0.device
    FX0 = res(X0)
    J0 = _qn_init_J(plan, X0, FX0)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    return QNLockCarry(
        u=X0, fu=FX0, nsteps=zeros, force_stop=false,
        retcode=torch.full_like(zeros, int(ReturnCode.Default)),
        stats=NLStats(zeros, zeros, zeros, zeros, zeros).incr(nf=1),
        term=trm.init_termination_batched(term_cfg, FX0, X0, reltol),
        J=J0, nresets=zeros, since_reset=zeros + 1, force_reinit=false,
        update_fu_prev=FX0, s_du=zeros, s_dfu=zeros,
        flags=_qn_reset_flags(plan, J0, FX0, FX0, torch.zeros_like(X0)))


def _qn_step(plan: _QNPlan, res, term_cfg, c: QNLockCarry, abstol,
             reltol) -> QNLockCarry:
    """One iteration of every row (``quasi_newton.step_quasi_newton``
    with no line search or trust region)."""
    u, fu = c.u, c.fu
    # the reinit decision, from the flags of the previous step
    rule_reset, s_du, s_dfu = _qn_reset_decide(plan, c)
    reinit = c.force_reinit | rule_reset
    nresets = c.nresets + reinit.to(c.nresets.dtype)
    resets_exhausted = reinit & (nresets >= plan.max_resets)
    since_reset = torch.where(reinit, torch.zeros_like(c.since_reset),
                              c.since_reset + 1)
    update_fu_prev = torch.where(_col(reinit), fu, c.update_fu_prev)
    shape = (-1,) + (1,) * (c.J.dim() - 1)
    J = torch.where(reinit.reshape(shape), _qn_init_J(plan, u, fu), c.J)
    du, linsolve_ok = _qn_descent(plan, J, fu)
    u_new = u + du
    fu_new = res(u_new)
    J_updated = _qn_update(plan, J, fu_new, update_fu_prev, du)
    flags = _qn_reset_flags(plan, J_updated, fu_new, fu, du)
    if plan.rule != "klement" and plan.reset.check_dfu:
        # a row that stays at fu checks |fu - fu| instead
        tol = _qn_reset_tol(plan, fu.dtype)
        stayed = ((fu - fu).abs() <= tol).any(-1)
        flags = flags[:-1] + (torch.where(linsolve_ok, flags[-1], stayed),)
    stats = c.stats.incr(nsteps=1, nsolve=1, nf=1)

    u_new = torch.where(_col(linsolve_ok), u_new, u)
    fu_new = torch.where(_col(linsolve_ok), fu_new, fu)
    # a failed solve right after a reset is a hard failure; otherwise the
    # next step reinitializes
    hard = ~linsolve_ok & (since_reset == 0)
    force_reinit = ~linsolve_ok & (since_reset > 0)
    stop, term = trm.check_termination_batched(
        term_cfg, c.term, fu_new, u_new, u, abstol, reltol,
        is_least_squares=res.is_least_squares)
    stop = stop & linsolve_ok
    term = select_rows(linsolve_ok, term, c.term)

    do_update = ~stop & ~force_reinit & linsolve_ok & ~resets_exhausted
    J_next = torch.where(do_update.reshape(shape), J_updated, J)
    update_fu_prev = torch.where(_col(do_update), fu_new, update_fu_prev)
    code = lambda rc: torch.full_like(c.retcode, int(rc))  # noqa: E731
    retcode = torch.where(stop, term.retcode.to(c.retcode.dtype),
                          code(ReturnCode.Default))
    retcode = torch.where(hard, code(ReturnCode.InternalLinearSolveFailed),
                          retcode)
    retcode = torch.where(resets_exhausted,
                          code(ReturnCode.ConvergenceFailure), retcode)
    return QNLockCarry(
        u=u_new, fu=fu_new, nsteps=c.nsteps + 1,
        force_stop=stop | hard | resets_exhausted, retcode=retcode,
        stats=stats, term=term, J=J_next, nresets=nresets,
        since_reset=since_reset, force_reinit=force_reinit,
        update_fu_prev=update_fu_prev, s_du=s_du, s_dfu=s_dfu, flags=flags)


def run_quasi_newton_lockstep(alg, res, term_cfg, X0, abstol, reltol,
                              maxiters: int) -> QNLockCarry:
    """Run the quasi-Newton ``alg`` on every row of ``X0`` in lockstep, as
    ``run_first_order_lockstep``."""
    plan = qn_plan_of(alg)
    c = _qn_init(plan, res, term_cfg, X0, reltol)
    while True:
        active = ~c.force_stop & (c.nsteps < maxiters)
        some, every = row_flags(active)
        if not some:
            break
        new = _qn_step(plan, res, term_cfg, c, abstol, reltol)
        c = new if every else select_rows(active, new, c)
    return _finish(c, res, term_cfg, maxiters)


# ---------------------------------------------------------------------------
# ladders
# ---------------------------------------------------------------------------

def _rows_of(res, idx):
    """The batched residual of the rows ``idx`` of ``res``'s batch."""
    if res.pdim is None:
        return res
    from ..utils.pytree import tree_map
    return dataclasses.replace(res, p=tree_map(lambda v: v[idx], res.p))


def run_polyalg_lockstep(alg: NonlinearSolvePolyAlgorithm, res, term_cfg,
                         X0, abstol, reltol, maxiters: int):
    """``polyalg.run_polyalg`` on every row: every row starts on the
    first rung; the rows that fail a rung run the next one as one
    lockstep batch from their own ``u0``, and each row keeps its
    lowest-residual iterate for when every rung fails.  Returns a carry
    with ``u``, ``fu``, ``retcode`` and ``stats`` (B rows)."""
    B = X0.shape[0]
    FX0 = res(X0)
    zeros = torch.zeros(B, dtype=torch.int32, device=X0.device)
    u, fu = X0, FX0
    retcode = torch.full_like(zeros, int(ReturnCode.Default))
    stats = [zeros] * 5
    done = torch.zeros(B, dtype=torch.bool, device=X0.device)
    best_u, best_fu = X0, FX0
    best_resid = torch.full((B,), float("inf"), dtype=_l2(FX0).dtype,
                            device=X0.device)
    best_retcode = torch.full_like(zeros, int(ReturnCode.Failure))
    success_codes = torch.tensor(_SUCCESSFUL, dtype=torch.int32,
                                 device=X0.device)
    idx = None                      # the rows still running (None: all)
    for sub in alg.algs[alg.start_index - 1:]:
        rows = (lambda x: x) if idx is None else (lambda x: x[idx])
        final = run_lockstep(
            sub, res if idx is None else _rows_of(res, idx), term_cfg,
            rows(X0), abstol, reltol, maxiters)
        success = torch.isin(final.retcode, success_codes)
        resid = _l2(final.fu)
        better = (resid < rows(best_resid)) & torch.isfinite(resid)

        def put(full, part, where=None):
            part = part if where is None else torch.where(
                where.reshape(where.shape + (1,) * (part.dim() - 1)),
                part, rows(full))
            if idx is None:
                return part
            out = full.clone()
            out[idx] = part
            return out

        stats = [put(s, rows(s) + getattr(final.stats, k)) for s, k in zip(
            stats, ("nf", "njacs", "nfactors", "nsolve", "nsteps"))]
        u = put(u, final.u, success)
        fu = put(fu, final.fu, success)
        retcode = put(retcode, final.retcode, success)
        done = put(done, success | rows(done))
        best_u = put(best_u, final.u, better)
        best_fu = put(best_fu, final.fu, better)
        best_resid = put(best_resid, resid, better)
        best_retcode = put(best_retcode, final.retcode, better)
        left = np.flatnonzero(~_backend.fetch(success.reshape(-1))[0])
        if left.size == 0:
            break
        left = torch.as_tensor(left, device=X0.device)
        idx = left if idx is None else idx[left]
    return LockCarry(
        u=torch.where(_col(done), u, best_u),
        fu=torch.where(_col(done), fu, best_fu),
        nsteps=stats[4], force_stop=done,
        retcode=torch.where(done, retcode, best_retcode),
        stats=NLStats(*stats), term=None)


def run_lockstep(alg, res, term_cfg, X0, abstol, reltol, maxiters: int):
    """An engine of ``lockstep_supported`` or a ladder of them on every row
    of ``X0``."""
    if isinstance(alg, NonlinearSolvePolyAlgorithm):
        return run_polyalg_lockstep(alg, res, term_cfg, X0, abstol, reltol,
                                    maxiters)
    if isinstance(alg, QuasiNewtonAlgorithm):
        return run_quasi_newton_lockstep(alg, res, term_cfg, X0, abstol,
                                         reltol, maxiters)
    return run_first_order_lockstep(alg, res, term_cfg, X0, abstol, reltol,
                                    maxiters)

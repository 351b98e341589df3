"""QuasiNewtonAlgorithm — Broyden / Klement / LimitedMemoryBroyden (the
port of ``solvers/quasi_newton.py``): a reset check, a quasi-Newton descent
on the stored Jacobian (J, J⁻¹, a diagonal or the low-rank ring), a line
search, a trust region or none, the termination check and the update rule.

* initializations: ``identity`` (αI, α = 2‖fu‖/max(‖u‖, 1) by default) and
  ``true_jacobian``; structures ``full`` | ``diagonal`` | ``low_rank``;
* update rules: good / bad Broyden on the inverse Jacobian (good Broyden
  in direct form under a trust region), Klement on the direct Jacobian,
  the diagonal variants, and the low-rank ring ``J⁻¹ ≈ -αI + UᵀV``;
* reset conditions: ``NoChangeInStateReset`` (3 steps with |δu| or |δfu|
  under eps^(3/4)) and ``IllConditionedJacobianReset`` (cond(J) ≥
  eps^(-1/2), or a zero on the diagonal).

The engine pattern is the first-order engine's (``first_order.py``): the
JAX ``lax.while_loop`` is a Python loop over device tensors and every
select on a flag is a host decision, all flags of a step coming from one
``_backend.fetch``.  The reset check that the JAX engine makes at the top
of a step from its carry rides on the previous step's read: its device
flags (|δu| and |δfu| small, or J ill-conditioned) are computed at the end
of a step for each outcome the read can choose between.  The Jacobian
update is computed before the read, as the JAX engine computes it before
its select, so the next check's flags can be taken from it.  Reads a step:
one (plain and trust-region steps); a line search reads once a trial, its
first trial carrying the step's flags, then once for the termination.
Dense solves defer their rank-deficient fallbacks as the first-order
engine's do.  The engine runs on the flattened state, as the JAX one does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .. import _backend
from ..core import descent as dsc
from ..core import linesearch as lsr
from ..core import termination as trm
from ..core import trust_region as trg
from ..core.autodiff import JacobianPolicy, construct_dense_jacobian_fn
from ..core.returncode import ReturnCode
from ..core.solution import NLStats
from ..core.tracing import init_trace, record_trace
from ..core.verbosity import traced_emit
from ..ops.linear_solve import (LinearSolver, deferred_fallbacks,
                                recorded_fallbacks, solve_dense)
from ..utils.norms import l2_norm
from .first_order import _read_groups


@dataclasses.dataclass(frozen=True)
class NoChangeInStateReset:
    nsteps: int = 3
    reset_tolerance: Optional[float] = None
    check_du: bool = True
    check_dfu: bool = True


@dataclasses.dataclass(frozen=True)
class IllConditionedJacobianReset:
    pass


@dataclasses.dataclass(frozen=True)
class QuasiNewtonAlgorithm:
    """The engine.  ``trustregion`` takes a ``GenericTrustRegionScheme``
    and globalizes with a Dogleg step on the approximate Jacobian, stored
    direct (the Broyden update then takes its direct-space rank-1 form);
    ``tr_reset_rejects`` consecutive rejections force a reinit."""

    update_rule: str = "good_broyden"   # good_broyden|bad_broyden|klement
    structure: str = "full"             # full | diagonal | low_rank
    threshold: int = 27                 # low_rank history depth η
    init_jacobian: str = "identity"     # identity | true_jacobian
    alpha: Optional[float] = None
    linesearch: Any = None
    trustregion: Any = None             # GenericTrustRegionScheme
    tr_reset_rejects: int = 3
    max_shrink_times: int = 2**31 - 2
    reinit_rule: Any = NoChangeInStateReset()
    max_resets: int = 100
    linsolve: LinearSolver = LinearSolver()
    jacobian: JacobianPolicy = JacobianPolicy()  # for true_jacobian init
    name: str = "QuasiNewton"

    def __post_init__(self):
        if self.trustregion is None:
            return
        if self.linesearch is not None:
            raise ValueError("cannot combine linesearch and trustregion "
                             "globalization (solve.jl:239-243)")
        if not isinstance(self.trustregion, trg.GenericTrustRegionScheme):
            raise ValueError("QuasiNewton trustregion must be a "
                             "GenericTrustRegionScheme")
        if self.structure != "full":
            raise ValueError("trust-region globalization needs the full "
                             "direct Jacobian structure (Dogleg needs J, "
                             "not J⁻¹ or a diagonal)")
        if self.update_rule == "bad_broyden":
            raise ValueError("bad_broyden is an inverse-Jacobian update "
                             "rule; use good_broyden or klement with "
                             "trustregion")

    @property
    def store_inverse(self) -> bool:
        # Broyden rules store J⁻¹, Klement stores J; a trust region forces
        # direct storage (Dogleg and the ratio model need J)
        if self.trustregion is not None:
            return False
        return self.update_rule in ("good_broyden", "bad_broyden")


def Broyden(*, max_resets: int = 100, linesearch=None, reset_tolerance=None,
            init_jacobian: str = "identity", autodiff=None, alpha=None,
            update_rule: str = "good_broyden"):
    """broyden.jl:35-50."""
    structure = "diagonal" if update_rule == "diagonal" else "full"
    rule = "good_broyden" if update_rule == "diagonal" else update_rule
    return QuasiNewtonAlgorithm(
        update_rule=rule, structure=structure, init_jacobian=init_jacobian,
        alpha=alpha, linesearch=linesearch,
        reinit_rule=NoChangeInStateReset(reset_tolerance=reset_tolerance),
        max_resets=max_resets, jacobian=autodiff or JacobianPolicy(),
        name="Broyden")


def LimitedMemoryBroyden(*, max_resets: int = 3, threshold: int = 27,
                         linesearch=None, reset_tolerance=None, alpha=None):
    """lbroyden.jl:21-36: the inverse Jacobian is ``-αI + UᵀV`` with an
    η-deep update ring (plain good Broyden when η ≥ n)."""
    return QuasiNewtonAlgorithm(
        update_rule="good_broyden", structure="low_rank",
        init_jacobian="identity", alpha=alpha, linesearch=linesearch,
        reinit_rule=NoChangeInStateReset(reset_tolerance=reset_tolerance),
        max_resets=max_resets, threshold=threshold,
        name="LimitedMemoryBroyden")


def Klement(*, max_resets: int = 100, linsolve=None, linesearch=None,
            alpha=None, init_jacobian: str = "identity", autodiff=None):
    """klement.jl:30-49 — diagonal Klement by default."""
    structure = "diagonal" if init_jacobian == "identity" else "full"
    if init_jacobian == "true_jacobian_diagonal":
        structure, init_jacobian = "diagonal", "true_jacobian"
    return QuasiNewtonAlgorithm(
        update_rule="klement", structure=structure,
        init_jacobian=init_jacobian, alpha=alpha, linesearch=linesearch,
        reinit_rule=IllConditionedJacobianReset(), max_resets=max_resets,
        linsolve=linsolve if linsolve is not None else LinearSolver(),
        jacobian=autodiff or JacobianPolicy(), name="Klement")


# ---------------------------------------------------------------------------
# The stored Jacobian
# ---------------------------------------------------------------------------

_EPS_GUARD = 1e-5


def _scalar(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _alpha_scaling(alpha, u, fu):
    """α of J = αI: 2‖fu‖₂ / max(‖u‖₂, 1) when unspecified, 1 for tiny
    residuals (a 0-d device tensor)."""
    if alpha is not None:
        return _scalar(alpha, u)
    fu_norm = l2_norm(fu)
    return torch.where(fu_norm < 1e-5, _scalar(1.0, u),
                       2.0 * fu_norm / torch.clamp(l2_norm(u), min=1.0))


def _init_J(alg: QuasiNewtonAlgorithm, jac_fn, u, fu):
    """The stored Jacobian at (re)initialization.  The low-rank ring is
    ``(U, V, count, α)`` with ``count`` a host int."""
    n = u.shape[0]
    if alg.structure == "low_rank":
        eta = min(alg.threshold, n)
        fx_norm = l2_norm(fu)
        alpha = torch.where(
            fx_norm >= 1e-5,
            torch.clamp(l2_norm(u), min=1.0) / (2.0 * fx_norm),
            _scalar(1.0, u))
        zeros = torch.zeros((eta, n), dtype=u.dtype, device=u.device)
        return (zeros, zeros.clone(), 0, alpha)
    if alg.init_jacobian == "identity":
        alpha = _alpha_scaling(alg.alpha, u, fu)
        scale = 1.0 / alpha if alg.store_inverse else alpha
        if alg.structure == "diagonal":
            return scale.expand(n).clone()
        return scale * torch.eye(n, dtype=u.dtype, device=u.device)
    J = jac_fn(u)
    if alg.structure == "diagonal":
        d = J.diagonal().clone()
        return 1.0 / d if alg.store_inverse else d
    if alg.store_inverse:
        eye = torch.eye(n, dtype=u.dtype, device=u.device)
        return solve_dense(J, eye, alg.linsolve)[0]
    return J


def _lr_mask(J):
    U, _, count, _ = J
    eta = U.shape[0]
    return (torch.arange(eta, device=U.device) < count)[:, None].to(U.dtype)


def _lr_matvec(J, v):
    """``(-αI + UᵀV) v`` over the ``count`` rows written."""
    U, V, _, alpha = J
    mask = _lr_mask(J)
    return torch.addcmul((U * mask).T @ ((V * mask) @ v), alpha, v,
                         value=-1.0)


def _lr_rmatvec(J, v):
    U, V, _, alpha = J
    mask = _lr_mask(J)
    return torch.addcmul((V * mask).T @ ((U * mask) @ v), alpha, v,
                         value=-1.0)


def _qn_descent(alg: QuasiNewtonAlgorithm, J, fu):
    """δu = -J⁻¹fu (stored inverse) or the solve Jδu = -fu; returns
    ``(δu, ok)`` with ``ok`` a 0-d device bool."""
    if alg.structure == "low_rank":
        _, _, count, alpha = J
        # an empty history seeds δu = -α·fu (lbroyden.jl:100-103)
        du = -alpha * fu if count == 0 else -_lr_matvec(J, fu)
        return du, torch.isfinite(du).all()
    if alg.structure == "diagonal":
        if alg.store_inverse:
            return -(J * fu), torch.ones((), dtype=torch.bool,
                                         device=fu.device)
        safe = torch.where(J == 0, torch.ones_like(J), J)
        du = -(fu / safe)
        return du, (J != 0).all() & torch.isfinite(du).all()
    if alg.store_inverse:
        du = -(J @ fu)
        return du, torch.isfinite(du).all()
    x, ok = solve_dense(J, fu, alg.linsolve)
    return -x, ok


# ---------------------------------------------------------------------------
# Reset rules: device flags, host decision
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ResetRuleState:
    steps_since_change_du: int
    steps_since_change_dfu: int
    dfu_prev: Any               # device tensor


def _reset_tol(rule: NoChangeInStateReset, dtype):
    if rule.reset_tolerance is not None:
        return rule.reset_tolerance
    return float(torch.finfo(dtype).eps) ** 0.75


def _ill_conditioned(alg: QuasiNewtonAlgorithm, J):
    """cond(J) ≥ 1/√eps or a zero singular value (a zero on the diagonal
    for the diagonal structure), as a 0-d device bool.  A non-finite J is
    not ill-conditioned (its singular values are NaN in the JAX
    package)."""
    if alg.structure == "diagonal":
        return (J == 0).any()
    fi = torch.finfo(J.dtype)
    finite = torch.isfinite(J).all()
    sv = torch.linalg.svdvals(torch.where(finite, J, 0.0))
    last = sv[-1]
    cond = sv[0] / torch.where(last == 0, _scalar(fi.tiny, last), last)
    return finite & ((cond >= 1.0 / float(np.sqrt(fi.eps))) | (last == 0))


def _reset_reads(alg: QuasiNewtonAlgorithm, rule, J, fu, dfu_prev, du):
    """The device flags one reset check needs, in order: J ill-conditioned;
    or |δu| small (``check_du``) and |fu - dfu_prev| small
    (``check_dfu``)."""
    if isinstance(rule, IllConditionedJacobianReset):
        return [_ill_conditioned(alg, J)]
    tol = _reset_tol(rule, fu.dtype)
    out = []
    if rule.check_du:
        out.append((du.abs() <= tol).any())
    if rule.check_dfu:
        out.append(((fu - dfu_prev).abs() <= tol).any())
    return out


def _reset_decide(rule, state: ResetRuleState, flags, fu):
    """The host half of the check: ``(reset, new_state)`` from the read
    values of ``_reset_reads`` at ``fu``."""
    if isinstance(rule, IllConditionedJacobianReset):
        return bool(flags[0]), state
    reset = False
    s_du, s_dfu = state.steps_since_change_du, state.steps_since_change_dfu
    at = 0
    if rule.check_du:
        small = bool(flags[at])
        at += 1
        s_du = s_du + 1 if small else 0
        s_dfu = s_dfu if small else 0
        reset = reset or (small and s_du >= rule.nsteps)
    if rule.check_dfu:
        small_f = bool(flags[at])
        s_dfu = s_dfu + 1 if small_f else 0
        s_du = s_du if (small_f or reset) else 0
        reset = reset or (small_f and s_dfu >= rule.nsteps)
    if reset:
        s_du = s_dfu = 0
    return reset, ResetRuleState(steps_since_change_du=s_du,
                                 steps_since_change_dfu=s_dfu, dfu_prev=fu)


def _reset_check(alg: QuasiNewtonAlgorithm, rule, state: ResetRuleState, J,
                 fu, u, du):
    """One reset check (flags read here): ``(reset, new_state)``."""
    flags = _backend.fetch(*_reset_reads(alg, rule, J, fu, state.dfu_prev,
                                         du))
    return _reset_decide(rule, state, flags, fu)


def _update_jacobian(alg: QuasiNewtonAlgorithm, J, fu, fu_prev, u, du):
    """The update rule (``J`` is J⁻¹ for the inverse-stored Broyden rules).
    Each ``a + b·c`` that XLA contracts in the JAX package's update is one
    ``addcmul`` here, so that it rounds once there too."""
    if alg.structure == "low_rank":
        # vᵀ = J⁻ᵀδx, u = (δx - J⁻¹δf)/⟨vᵀ, δf⟩, written into the ring
        U, V, count, alpha = J
        eta = U.shape[0]
        dfu = fu - fu_prev
        vT = _lr_rmatvec(J, du)
        mvec = _lr_matvec(J, dfu)
        d = torch.dot(vT, dfu)
        d = torch.where(d == 0, _scalar(_EPS_GUARD, d), d)
        slot = count % eta
        U, V = U.clone(), V.clone()
        U[slot] = (du - mvec) / d
        V[slot] = vT
        return (U, V, count + 1, alpha)
    if alg.update_rule in ("good_broyden", "bad_broyden"):
        dfu = fu - fu_prev
        if not alg.store_inverse:
            # direct-space good Broyden (the trust-region path)
            denom = torch.dot(du, du)
            denom = torch.where(denom == 0, _scalar(_EPS_GUARD, denom),
                                denom)
            return torch.addcmul(J, ((dfu - J @ du) / denom)[:, None],
                                 du[None, :])
        if alg.structure == "diagonal":
            d = J
            if alg.update_rule == "good_broyden":
                Jdfu = d * dfu * du
                denom = torch.sum(Jdfu)
                denom = torch.where(denom == 0, _scalar(_EPS_GUARD, denom),
                                    denom)
                return d + (du - Jdfu) * du * d / denom
            denom = l2_norm(dfu) ** 2
            denom = torch.where(denom == 0, _scalar(_EPS_GUARD, denom),
                                denom)
            return d + torch.addcmul(du, d, dfu, value=-1.0) * dfu / denom
        Jdfu = J @ dfu
        if alg.update_rule == "good_broyden":
            denom = torch.dot(du, Jdfu)
            row = du @ J
        else:
            denom = l2_norm(dfu) ** 2
            row = dfu
        denom = torch.where(denom == 0, _scalar(_EPS_GUARD, denom), denom)
        return torch.addcmul(J, ((du - Jdfu) / denom)[:, None], row[None, :])

    # Klement
    if alg.structure == "diagonal":
        d = J
        Jdu = d * d * du * du
        Jdu = torch.where(Jdu == 0, _scalar(_EPS_GUARD, Jdu), Jdu)
        q = torch.addcmul(fu - fu_prev, d, du, value=-1.0) / Jdu
        return torch.addcmul(d, q * du * d, d)
    denom_vec = (J * J).T @ (du * du)      # Σ_j J[j,i]² du[j]²
    denom_vec = torch.where(denom_vec == 0, _scalar(_EPS_GUARD, denom_vec),
                            denom_vec)
    resid = (fu - fu_prev - J @ du) / denom_vec
    return J + (resid[:, None] * du[None, :] * J) @ J


def resolve_low_rank(alg: QuasiNewtonAlgorithm, n: int):
    """A low-rank history at least as deep as the state is a full inverse:
    run plain (full) good Broyden, as the reference's Simple tier does."""
    if alg.structure == "low_rank" and n <= alg.threshold:
        return dataclasses.replace(alg, structure="full")
    return alg


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QNCarry:
    u: Any
    fu: Any
    J: Any                      # (n,n), (n,) diagonal or the low-rank ring
    nsteps: int
    nresets: int
    steps_since_last_reset: int
    force_stop: bool
    force_reinit: bool
    retcode: int
    stats: NLStats
    term: trm.TermState
    ls_state: Any
    update_fu_prev: Any         # fu at the last update
    reset_state: ResetRuleState
    reset_flags: list           # host flags of the next reset check
    tr_state: Any = None
    tr_rejects: int = 0
    exact_fallbacks: bool = False   # the last step needed a fallback
    njvp: int = 0
    krylov_iters: int = 0
    trace_state: Any = None

    def replace(self, **kw) -> "QNCarry":
        return dataclasses.replace(self, **kw)


def flat_ctx(ctx: dsc.DescentCtx, shape):
    """The context on the flattened state (the JAX engines run flat), and
    a dict whose "fu" is the residual's own shape once ``f`` has run."""
    seen = {}
    if len(shape) == 1:
        return ctx, seen
    f, post = ctx.f_flat, ctx.postcondition

    def f_flat(v):
        out = f(v.reshape(shape))
        seen["fu"] = out.shape
        return out.reshape(-1)

    flat_post = None
    if post is not None:
        def flat_post(v, v_prev):
            return post(v.reshape(shape), v_prev.reshape(shape)).reshape(-1)

    return dataclasses.replace(ctx, f_flat=f_flat,
                               postcondition=flat_post), seen


def init_quasi_newton(alg: QuasiNewtonAlgorithm, ctx, term_cfg, jac_fn, u0,
                      reltol) -> QNCarry:
    """``u0`` and ``ctx`` are flat."""
    alg = resolve_low_rank(alg, int(u0.numel()))
    fu0 = ctx.f_flat(u0)
    J0 = _init_J(alg, jac_fn, u0, fu0)
    host = _read_groups({
        "term": trm.init_norms(term_cfg, fu0, u0),
        "reset": _reset_reads(alg, alg.reinit_rule, J0, fu0, fu0,
                              torch.zeros_like(u0)),
        "tr": (trg.tr_init_reads(alg.trustregion, ctx, fu0, u0)
               if alg.trustregion is not None else []),
        "ls": (lsr.ls_init_reads(alg.linesearch, fu0)
               if alg.linesearch is not None else [])})
    njacs = 1 if alg.init_jacobian == "true_jacobian" else 0
    return QNCarry(
        u=u0, fu=fu0, J=J0, nsteps=0, nresets=0,
        steps_since_last_reset=1, force_stop=False, force_reinit=False,
        retcode=int(ReturnCode.Default),
        stats=NLStats.zeros().incr(nf=1, njacs=njacs),
        term=trm.init_termination(term_cfg, fu0, u0, reltol,
                                  norms=host["term"]),
        ls_state=(lsr.ls_init(alg.linesearch, fu0, host["ls"])
                  if alg.linesearch is not None else None),
        update_fu_prev=fu0,
        reset_state=ResetRuleState(0, 0, fu0), reset_flags=host["reset"],
        tr_state=(trg.tr_init(alg.trustregion, u0, host["tr"])
                  if alg.trustregion is not None else None),
        trace_state=init_trace(ctx.trace, u0))


@dataclasses.dataclass
class _Trial:
    """The device half of one step, up to its host read."""

    J: Any
    du: Any
    u_new: Any
    fu_new: Any
    J_updated: Any
    du_taken: Any
    tr_result: Any = None
    ls_res: Any = None
    ls_reset: bool = False      # a failed search after the burn-in
    host: dict = dataclasses.field(default_factory=dict)
    nf_post: int = 0            # the postcondition's residual evaluation


def _attempt(alg: QuasiNewtonAlgorithm, ctx, term_cfg, jac_fn,
             carry: QNCarry, reinit: bool, update_fu_prev,
             steps_since_last_reset: int, abstol, reltol,
             deferred: bool) -> _Trial:
    """Reinit, descent, globalization, the speculative update and the
    step's one read (besides a line search's).  ``deferred``: leave the
    dense solves' fallbacks undecided and read their flags (key "retry")
    with the step; otherwise decide each as it comes (key "fell_back")."""
    u, fu = carry.u, carry.fu
    pending = _backend.PendingReads()
    with (deferred_fallbacks() if deferred
          else recorded_fallbacks()) as flags:
        J = _init_J(alg, jac_fn, u, fu) if reinit else carry.J
        tr_result = None
        if alg.trustregion is not None:
            # Dogleg on the direct-stored approximate Jacobian
            dogleg = dsc.Dogleg(newton=dsc.NewtonDescent(
                linsolve=alg.linsolve))
            tr_result, _ = dsc.descent_solve(
                dogleg, None, ctx, J, fu, u,
                trust_region=carry.tr_state.trust_region)
            du, linsolve_ok = tr_result.du, tr_result.linsolve_success
        else:
            du, linsolve_ok = _qn_descent(alg, J, fu)
    if deferred and flags:
        pending.defer("retry", torch.stack(flags).any())
    pending.defer("linsolve_ok", linsolve_ok)

    groups = {}
    trial = _Trial(J=J, du=du, u_new=None, fu_new=None, J_updated=None,
                   du_taken=du, tr_result=tr_result)
    fu_secant = None
    if alg.trustregion is not None:
        trial.u_new, trial.fu_new, groups["tr"] = trg.tr_candidate(
            alg.trustregion, carry.tr_state, ctx, J, fu, u, du, tr_result)
        # the trial residual is the secant data, accepted or not
        fu_secant = trial.fu_new
        groups["term_old"] = trm.termination_norms(
            term_cfg, fu, u, u, abstol=abstol, reltol=reltol)
    elif alg.linesearch is not None:
        trial.ls_res = lsr.ls_solve(alg.linesearch, carry.ls_state, ctx, u,
                                    du, fu, None, carry.nsteps,
                                    read=pending.read)
        # a failed search after a burn-in of 5 steps resets J and steps
        # with α = 0 (solve.jl:404-408)
        trial.ls_reset = ((not trial.ls_res.success)
                          and steps_since_last_reset > 5)
        alpha = (type(trial.ls_res.alpha)(0) if trial.ls_reset
                 else trial.ls_res.alpha)
        trial.u_new = lsr.at(u, alpha, du)
        # the secant step of the Broyden family is the step taken (α·δu);
        # Klement keeps the raw direction (the JAX package's choice)
        if alg.update_rule != "klement":
            trial.du_taken = float(alpha) * du
        trial.fu_new = ctx.f_flat(trial.u_new)
        groups["ls_post"] = lsr.ls_post_reads(alg.linesearch, trial.fu_new)
    else:
        trial.u_new = u + du
        trial.fu_new = ctx.f_flat(trial.u_new)
    if ctx.postcondition is not None:
        # the corrector at the commit point (a rejected trust-region step
        # keeps the old iterate instead)
        trial.u_new = ctx.postcondition(trial.u_new, u)
        trial.fu_new = ctx.f_flat(trial.u_new)
        trial.nf_post = 1
    groups["term"] = trm.termination_norms(
        term_cfg, trial.fu_new, trial.u_new, u, abstol=abstol, reltol=reltol)

    # the update, as if it were taken (the JAX engine computes it before
    # its select), and the next reset check's flags for each outcome:
    # the iterate moved to fu_new, or stayed at fu
    trial.J_updated = _update_jacobian(
        alg, J, trial.fu_new if fu_secant is None else fu_secant,
        update_fu_prev, trial.u_new, trial.du_taken)
    rule = alg.reinit_rule
    groups["reset_moved"] = _reset_reads(alg, rule, trial.J_updated,
                                         trial.fu_new, fu, du)
    if isinstance(rule, NoChangeInStateReset) and rule.check_dfu:
        groups["dfu_stayed"] = [((fu - fu).abs()
                                 <= _reset_tol(rule, fu.dtype)).any()]
    trial.host = {**_read_groups(groups, pending.read), **pending.values}
    if not deferred:
        trial.host["fell_back"] = any(flags)
    return trial


def step_quasi_newton(alg: QuasiNewtonAlgorithm, ctx, term_cfg, jac_fn,
                      carry: QNCarry, abstol, reltol) -> QNCarry:
    """One iteration (solve.jl:293-482) on the flat state."""
    alg = resolve_low_rank(alg, int(carry.u.numel()))
    u, fu = carry.u, carry.fu

    # --- reinit decision (its flags came with the previous step's read) ---
    rule_reset, reset_state = _reset_decide(
        alg.reinit_rule, carry.reset_state, carry.reset_flags, fu)
    reinit = carry.force_reinit or rule_reset
    nresets = carry.nresets + int(reinit)
    resets_exhausted = reinit and nresets >= alg.max_resets
    steps_since_last_reset = (0 if reinit
                              else carry.steps_since_last_reset + 1)
    # the secant base residual: a reset clears it too
    update_fu_prev = fu if reinit else carry.update_fu_prev
    traced_emit(ctx.verbosity, "threshold_state", reinit,
                "approximate-Jacobian reset #{n} (structure "
                f"{alg.structure}, threshold {alg.threshold})", n=nresets)

    trial = _attempt(alg, ctx, term_cfg, jac_fn, carry, reinit,
                     update_fu_prev, steps_since_last_reset, abstol, reltol,
                     deferred=not carry.exact_fallbacks)
    if trial.host.get("retry"):
        # a dense solve wanted its rank-deficient fallback: run the step
        # again with every fallback decided as it comes
        trial = _attempt(alg, ctx, term_cfg, jac_fn, carry, reinit,
                         update_fu_prev, steps_since_last_reset, abstol,
                         reltol, deferred=False)
    host, J, du = trial.host, trial.J, trial.du
    linsolve_ok = bool(host["linsolve_ok"])
    stats = carry.stats.incr(
        nsteps=1, nsolve=1, nf=trial.nf_post,
        njacs=int(reinit and alg.init_jacobian == "true_jacobian"))

    # --- globalization ----------------------------------------------------
    force_reinit_next = False
    ls_state, tr_state = carry.ls_state, carry.tr_state
    tr_rejects = 0 if reinit else carry.tr_rejects
    accepted, shrink_exceeded = True, False
    u_new, fu_new, term_norms = trial.u_new, trial.fu_new, host["term"]
    if alg.trustregion is not None:
        accepted, tr_state = trg.tr_update(alg.trustregion, tr_state,
                                           host["tr"], trial.tr_result, du)
        stats = stats.incr(nf=1)
        if not accepted:
            u_new, fu_new, term_norms = u, fu, host["term_old"]
        counter = trg.tr_shrink_counter(tr_state)
        if counter is not None:
            shrink_exceeded = counter > alg.max_shrink_times
        # a streak of rejections rebuilds J
        tr_rejects = 0 if accepted else tr_rejects + 1
        streak = (not accepted and tr_rejects >= alg.tr_reset_rejects
                  and steps_since_last_reset > 0)
        force_reinit_next = streak
        if streak:
            tr_rejects = 0
    elif alg.linesearch is not None:
        ls_res = trial.ls_res
        force_reinit_next = trial.ls_reset
        stats = stats.incr(nf=ls_res.nf + 1)
        ls_state = lsr.ls_post_step(alg.linesearch, ls_res.state,
                                    host["ls_post"])
    else:
        stats = stats.incr(nf=1)

    moved = linsolve_ok and accepted
    if not linsolve_ok:
        u_new, fu_new = u, fu
    # a failed solve right after a reset is a hard failure; otherwise the
    # next step reinitializes (solve.jl:377-397)
    hard_lin_fail = (not linsolve_ok) and steps_since_last_reset == 0
    stale_lin_fail = (not linsolve_ok) and steps_since_last_reset > 0
    force_reinit_next = force_reinit_next or stale_lin_fail
    traced_emit(ctx.verbosity, "linsolve_failed_noncurrent", stale_lin_fail,
                "linear solve failed with a stale approximate Jacobian; "
                "retrying with a reinitialized Jacobian (QN solve.jl:385)")

    # --- termination ------------------------------------------------------
    if linsolve_ok:
        stop, term = trm.check_termination(
            term_cfg, carry.term, fu_new, u_new, u, abstol, reltol,
            norms=term_norms, is_least_squares=ctx.is_least_squares)
    else:
        stop, term = False, carry.term

    # --- Jacobian update (skipped on a stop or a pending reinit) ----------
    do_update = (not stop and not force_reinit_next and linsolve_ok
                 and not resets_exhausted and not shrink_exceeded)
    J_next = trial.J_updated if do_update else J
    if do_update and accepted:
        update_fu_prev = fu_new
    # the next check's flags: a skipped update stops the solve or forces a
    # reinit, so the flags of the updated J are the ones that can matter
    flags = list(host["reset_moved"])
    if not moved and "dfu_stayed" in host:
        flags[-1] = host["dfu_stayed"][0]

    retcode = int(ReturnCode.Default)
    if shrink_exceeded:
        retcode = int(ReturnCode.ShrinkThresholdExceeded)
    if stop:
        retcode = term.retcode
    if hard_lin_fail:
        retcode = int(ReturnCode.InternalLinearSolveFailed)
    if resets_exhausted:
        retcode = int(ReturnCode.ConvergenceFailure)
    force_stop = (stop or hard_lin_fail or resets_exhausted
                  or shrink_exceeded)

    return QNCarry(
        u=u_new, fu=fu_new, J=J_next, nsteps=carry.nsteps + 1,
        nresets=nresets, steps_since_last_reset=steps_since_last_reset,
        force_stop=force_stop, force_reinit=force_reinit_next,
        retcode=retcode, stats=stats, term=term, ls_state=ls_state,
        update_fu_prev=update_fu_prev, reset_state=reset_state,
        reset_flags=flags, tr_state=tr_state, tr_rejects=tr_rejects,
        exact_fallbacks=bool(host.get("fell_back")),
        trace_state=record_trace(ctx.trace, carry.trace_state,
                                 carry.nsteps + 1, fu_new, du, J_next,
                                 u_new))


def finish(carry, ctx, term_cfg, maxiters: int, shape, seen):
    """``_run_cache_to_completion!``: Default → MaxIters or Success, the
    safe-best iterate with f re-evaluated at it, and the state and the
    residual back in their shapes (``seen``: from ``flat_ctx``)."""
    retcode = carry.retcode
    if retcode == ReturnCode.Default:
        retcode = int(ReturnCode.MaxIters if carry.nsteps >= maxiters
                      else ReturnCode.Success)
    u_final = trm.termination_result(term_cfg, carry.term, carry.u)
    if term_cfg.keeps_best:
        fu_final = ctx.f_flat(u_final)
        carry = carry.replace(stats=carry.stats.incr(nf=1))
    else:
        fu_final = carry.fu
    return carry.replace(u=u_final.reshape(shape),
                         fu=fu_final.reshape(seen.get("fu", (-1,))),
                         retcode=retcode)


def run_quasi_newton(alg: QuasiNewtonAlgorithm, ctx, term_cfg, analytic_jac,
                     u0, abstol, reltol, maxiters):
    """init + loop to completion on the flattened state; returns the final
    carry with ``u`` and ``fu`` in their shapes.  ``analytic_jac(u)`` takes
    the state in its shape and returns the 2-D Jacobian."""
    shape = u0.shape
    fctx, seen = flat_ctx(ctx, shape)
    u_flat = u0.reshape(-1)
    alg = resolve_low_rank(alg, int(u_flat.numel()))
    analytic = (None if analytic_jac is None
                else (lambda v: analytic_jac(v.reshape(shape))))
    jac_fn = construct_dense_jacobian_fn(fctx.f_flat, alg.jacobian,
                                         fctx.n_in, fctx.n_out, analytic)
    carry = init_quasi_newton(alg, fctx, term_cfg, jac_fn, u_flat, reltol)
    while not carry.force_stop and carry.nsteps < maxiters:
        carry = step_quasi_newton(alg, fctx, term_cfg, jac_fn, carry,
                                  abstol, reltol)
    return finish(carry, fctx, term_cfg, maxiters, shape, seen)

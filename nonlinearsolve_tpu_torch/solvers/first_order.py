"""GeneralizedFirstOrderAlgorithm — the Newton-family engine (the port of
``solvers/first_order.py``): Jacobian → descent → globalization (line
search, trust region or none) → termination check → post-step hooks, and
the algorithms built from it: ``NewtonRaphson``, ``GaussNewton``,
``TrustRegion``, ``LevenbergMarquardt`` and ``PseudoTransient``.

The JAX engine's ``lax.while_loop`` becomes a Python loop over device
tensors, and its ``jnp.where`` selects become host decisions made once per
step from one ``_backend.fetch``: the linear solve's finiteness, the
descent's success, the trust region's ratio, the termination norms and
‖fu‖ for the forcing term.  A line-search step reads once per trial
instead, its first trial's read carrying the step's own flags, then once
for the termination.  The linear solves' rank-deficient fallbacks are
deferred (``ops.linear_solve.deferred_fallbacks``): their flags ride on
the same read, and when one is set the step runs again with every fallback
decided (the JAX package's results, at the cost of more reads on that
step).  Krylov solves add their own reads.
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
from ..core.autodiff import JacobianPolicy
from ..core.jacobian import construct_jacobian
from ..core.returncode import ReturnCode
from ..core.solution import NLStats
from ..core.tracing import init_trace, record_trace
from ..core.verbosity import traced_emit
from ..ops.linear_solve import deferred_fallbacks, recorded_fallbacks
from ..utils.norms import l2_norm


@dataclasses.dataclass(frozen=True)
class EisenstatWalkerForcing:
    """Inexact-Newton forcing, Eisenstat–Walker (1996) algorithm 2 / formula
    (2.6): ηₖ = γ(‖rₖ‖/‖rₖ₋₁‖)^α with the over-solving safeguard."""

    eta_0: float = 0.5
    eta_max: float = 0.9
    gamma: float = 0.9
    alpha: float = 2.0
    safeguard: bool = True
    safeguard_threshold: float = 0.1


# the JAX package's second name for the same forcing
EisenstatWalkerForcing2 = EisenstatWalkerForcing


@dataclasses.dataclass(frozen=True)
class ForcingState:
    eta: Any            # host scalars in the working dtype
    rnorm: Any
    rnorm_prev: Any


@dataclasses.dataclass(frozen=True)
class GeneralizedFirstOrderAlgorithm:
    descent: Any = dsc.NewtonDescent()
    linesearch: Any = None
    trustregion: Any = None
    jacobian: JacobianPolicy = JacobianPolicy()
    forcing: Any = None
    concrete_jac: Any = None
    max_shrink_times: int = 32
    name: str = "GeneralizedFirstOrder"

    def __post_init__(self):
        if self.linesearch is not None and self.trustregion is not None:
            raise ValueError("cannot combine linesearch and trustregion "
                             "globalization")

    def get_linsolve(self):
        d = self.descent
        while isinstance(d, dsc.GeodesicAcceleration):
            d = d.descent
        if isinstance(d, dsc.Dogleg):
            d = d.newton
        return getattr(d, "linsolve", None)

    @property
    def globalization(self) -> str:
        if self.linesearch is not None:
            return "linesearch"
        if self.trustregion is not None:
            return "trustregion"
        return "none"


def _linsolve(linsolve):
    from ..ops.linear_solve import LinearSolver
    return linsolve if linsolve is not None else LinearSolver()


def NewtonRaphson(*, linsolve=None, linesearch=None, autodiff=None,
                  forcing=None, concrete_jac=None):
    """Newton descent, optionally with a line search (raphson.jl)."""
    return GeneralizedFirstOrderAlgorithm(
        descent=dsc.NewtonDescent(linsolve=_linsolve(linsolve)),
        linesearch=linesearch, jacobian=autodiff or JacobianPolicy(),
        forcing=forcing, concrete_jac=concrete_jac, name="NewtonRaphson")


def GaussNewton(*, linsolve=None, linesearch=None, autodiff=None):
    """Newton descent on the least-squares problem (gauss_newton.jl)."""
    return GeneralizedFirstOrderAlgorithm(
        descent=dsc.NewtonDescent(linsolve=_linsolve(linsolve)),
        linesearch=linesearch, jacobian=autodiff or JacobianPolicy(),
        name="GaussNewton")


def TrustRegion(*, radius_update_scheme: str = "simple",
                max_trust_radius=None, initial_trust_radius=None,
                step_threshold=None, shrink_threshold=None,
                expand_threshold=None, shrink_factor=None,
                expand_factor=None, max_shrink_times=32, autodiff=None,
                linsolve=None):
    """The dogleg descent with a generic trust-region scheme
    (trust_region.jl); ``radius_update_scheme`` names one of the seven
    schemes (``RadiusUpdateSchemes``)."""
    return GeneralizedFirstOrderAlgorithm(
        descent=dsc.Dogleg(newton=dsc.NewtonDescent(
            linsolve=_linsolve(linsolve))),
        trustregion=trg.GenericTrustRegionScheme(
            method=radius_update_scheme, max_trust_radius=max_trust_radius,
            initial_trust_radius=initial_trust_radius,
            step_threshold=step_threshold, shrink_threshold=shrink_threshold,
            expand_threshold=expand_threshold, shrink_factor=shrink_factor,
            expand_factor=expand_factor),
        jacobian=autodiff or JacobianPolicy(),
        max_shrink_times=max_shrink_times, name="TrustRegion")


def LevenbergMarquardt(*, damping_initial: float = 1.0,
                       alpha_geodesic: float = 0.75,
                       disable_geodesic: bool = False,
                       damping_increase_factor: float = 2.0,
                       damping_decrease_factor: float = 3.0,
                       finite_diff_step_geodesic: float = 0.1,
                       b_uphill: float = 1.0, min_damping_D: float = 1e-8,
                       autodiff=None, linsolve=None):
    """A damped Newton descent with LM damping, wrapped in geodesic
    acceleration, under the LM trust region (levenberg_marquardt.jl)."""
    from ..core.damping import LevenbergMarquardtDamping
    descent = dsc.DampedNewtonDescent(
        initial_damping=damping_initial,
        damping=LevenbergMarquardtDamping(
            increase_factor=damping_increase_factor,
            decrease_factor=damping_decrease_factor,
            min_damping=min_damping_D),
        linsolve=_linsolve(linsolve))
    if not disable_geodesic:
        descent = dsc.GeodesicAcceleration(
            descent=descent, finite_diff_step=finite_diff_step_geodesic,
            alpha=alpha_geodesic)
    return GeneralizedFirstOrderAlgorithm(
        descent=descent,
        trustregion=trg.LevenbergMarquardtTrustRegion(b_uphill=b_uphill),
        jacobian=autodiff or JacobianPolicy(), concrete_jac=True,
        name="LevenbergMarquardt")


def PseudoTransient(*, alpha_initial: float = 1e-3, autodiff=None,
                    linsolve=None, mass_matrix=None):
    """A damped Newton descent with SER damping (pseudo_transient.jl); a
    mass matrix makes the step ``(J + (1/α)M) δu = -F``."""
    from ..core.damping import SwitchedEvolutionRelaxation
    return GeneralizedFirstOrderAlgorithm(
        descent=dsc.DampedNewtonDescent(
            initial_damping=alpha_initial,
            damping=SwitchedEvolutionRelaxation(mass_matrix=mass_matrix),
            linsolve=_linsolve(linsolve)),
        jacobian=autodiff or JacobianPolicy(), name="PseudoTransient")


@dataclasses.dataclass(frozen=True)
class FOCarry:
    u: Any
    fu: Any
    nsteps: int
    force_stop: bool
    retcode: int
    stats: NLStats
    term: trm.TermState
    descent_state: Any
    tr_state: Any = None
    ls_state: Any = None
    forcing_state: Optional[ForcingState] = None
    njvp: int = 0
    krylov_iters: int = 0
    exact_fallbacks: bool = False   # the last step needed a fallback
    trace_state: Any = None

    def replace(self, **kw) -> "FOCarry":
        return dataclasses.replace(self, **kw)


def _read_groups(groups: dict, read=_backend.fetch) -> dict:
    """Read every device scalar of ``groups`` (name -> list) with one
    ``read``; returns the host values under the same names."""
    flat = [t for g in groups.values() for t in g]
    host = read(*flat) if flat else []
    out, at = {}, 0
    for k, g in groups.items():
        out[k] = host[at:at + len(g)]
        at += len(g)
    return out


def init_first_order(alg: GeneralizedFirstOrderAlgorithm, ctx: dsc.DescentCtx,
                     term_cfg: trm.TerminationCondition, u0, reltol):
    fu0 = ctx.f_flat(u0)
    host = _read_groups({
        "term": trm.init_norms(term_cfg, fu0, u0),
        "rnorm": [l2_norm(fu0)] if alg.forcing is not None else [],
        "tr": (trg.tr_init_reads(alg.trustregion, ctx, fu0, u0)
               if alg.trustregion is not None else []),
        "ls": (lsr.ls_init_reads(alg.linesearch, fu0)
               if alg.linesearch is not None else [])})
    term = trm.init_termination(term_cfg, fu0, u0, reltol,
                                norms=host["term"])
    forcing_state = None
    if alg.forcing is not None:
        eta_0 = _backend.real_np_dtype(u0.dtype)(alg.forcing.eta_0)
        forcing_state = ForcingState(eta=eta_0, rnorm=host["rnorm"][0],
                                     rnorm_prev=host["rnorm"][0])
    return FOCarry(
        u=u0, fu=fu0, nsteps=0, force_stop=False,
        retcode=int(ReturnCode.Default), stats=NLStats.zeros().incr(nf=1),
        term=term,
        descent_state=dsc.descent_init(alg.descent, ctx, None, fu0, u0),
        tr_state=(trg.tr_init(alg.trustregion, u0, host["tr"])
                  if alg.trustregion is not None else None),
        ls_state=(lsr.ls_init(alg.linesearch, fu0, host["ls"])
                  if alg.linesearch is not None else None),
        forcing_state=forcing_state,
        trace_state=init_trace(ctx.trace, u0))


def _forcing_eta(fcfg: EisenstatWalkerForcing, fs: ForcingState, nsteps: int,
                 npdt):
    """Eisenstat–Walker pre-step, in the working dtype."""
    if nsteps == 0:
        return npdt(fcfg.eta_0)
    eta_new = npdt(fcfg.gamma) * (fs.rnorm / fs.rnorm_prev) ** npdt(fcfg.alpha)
    if fcfg.safeguard:
        eta_sg = npdt(fcfg.gamma) * fs.eta ** npdt(fcfg.alpha)
        if eta_sg > npdt(fcfg.safeguard_threshold) and eta_sg > eta_new:
            eta_new = eta_sg
    return npdt(np.clip(eta_new, npdt(0), npdt(fcfg.eta_max)))


@dataclasses.dataclass
class _Trial:
    """The device half of one step, up to its host read."""

    result: dsc.DescentResult
    descent_state: Any
    u_new: Any
    fu_new: Any
    ls_res: Any = None
    host: dict = dataclasses.field(default_factory=dict)
    nf_post: int = 0            # the postcondition's residual evaluation


def _attempt(alg, ctx, term_cfg, carry: FOCarry, J, krylov_rtol, abstol,
             reltol, deferred: bool) -> _Trial:
    """Descent, globalization and the step's one read (besides a line
    search's).  ``deferred``: leave the linear solves' fallbacks undecided
    and read their flags (key "retry") with the step; otherwise decide
    each as it comes (key "fell_back": whether one ran)."""
    u, fu = carry.u, carry.fu
    pending = _backend.PendingReads()
    ctx.mark("descent")
    with (deferred_fallbacks() if deferred
          else recorded_fallbacks()) as flags:
        tr_radius = (carry.tr_state.trust_region
                     if isinstance(carry.tr_state, trg.TRState) else None)
        result, descent_state = dsc.descent_solve(
            alg.descent, carry.descent_state, ctx, J, fu, u,
            trust_region=tr_radius, krylov_rtol=krylov_rtol)
    if deferred and flags:
        pending.defer("retry", torch.stack(flags).any())
    pending.defer("linsolve_ok", result.linsolve_success)
    pending.defer("success", result.success)
    du = result.du

    trial = _Trial(result=result, descent_state=descent_state, u_new=None,
                   fu_new=None)
    glob = alg.globalization
    groups = {}
    ctx.mark("linesearch" if glob in ("linesearch", "trustregion")
             else "other")
    if glob == "linesearch":
        trial.ls_res = lsr.ls_solve(alg.linesearch, carry.ls_state, ctx, u,
                                    du, fu, J, carry.nsteps,
                                    read=pending.read)
        trial.u_new = lsr.at(u, trial.ls_res.alpha, du)
        trial.fu_new = ctx.f_flat(trial.u_new)
        groups["ls_post"] = lsr.ls_post_reads(alg.linesearch, trial.fu_new)
    elif glob == "trustregion":
        trial.u_new, trial.fu_new, groups["tr"] = trg.tr_candidate(
            alg.trustregion, carry.tr_state, ctx, J, fu, u, du, result)
        # the check of a rejected step sees the old iterate again
        groups["term_old"] = trm.termination_norms(
            term_cfg, fu, u, u, abstol=abstol, reltol=reltol)
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
    if alg.forcing is not None:
        groups["rnorm"] = [l2_norm(trial.fu_new)]
    # the step's read (the queued flags ride on it unless a line search's
    # first trial took them)
    trial.host = {**_read_groups(groups, pending.read), **pending.values}
    if not deferred:
        trial.host["fell_back"] = any(flags)
    return trial


def step_first_order(alg: GeneralizedFirstOrderAlgorithm,
                     ctx: dsc.DescentCtx, term_cfg: trm.TerminationCondition,
                     jac_fn, carry: FOCarry, abstol, reltol) -> FOCarry:
    """One iteration (solve.jl:298-426)."""
    u, fu = carry.u, carry.fu
    npdt = _backend.real_np_dtype(u.dtype)
    ctx.mark("jacobian")
    J = jac_fn(u)
    stats = carry.stats.incr(njacs=1, nsteps=1)

    krylov_rtol = None
    forcing_state = carry.forcing_state
    if alg.forcing is not None:
        eta = _forcing_eta(alg.forcing, forcing_state, carry.nsteps, npdt)
        forcing_state = dataclasses.replace(forcing_state, eta=eta)
        krylov_rtol = eta
        traced_emit(ctx.verbosity, "forcing", True,
                    "Eisenstat-Walker forcing eta = {eta} "
                    "(eisenstat_walker.jl:44)", eta=eta)

    # A step defers its fallbacks unless the last one needed one (then a
    # run of singular steps pays one read a fallback, not a wasted attempt)
    trial = _attempt(alg, ctx, term_cfg, carry, J, krylov_rtol, abstol,
                     reltol, deferred=not carry.exact_fallbacks)
    if trial.host.get("retry"):
        # a linear solve wanted its rank-deficient fallback: run the step
        # again with every fallback decided as it comes
        trial = _attempt(alg, ctx, term_cfg, carry, J, krylov_rtol, abstol,
                         reltol, deferred=False)
    result, host = trial.result, trial.host
    stats = stats.incr(nf=result.nf + trial.nf_post, nsolve=result.nsolve,
                       nfactors=result.nfactors)
    linsolve_ok = bool(host["linsolve_ok"])
    success = bool(host["success"])
    descent_ok = success and linsolve_ok
    u_new, fu_new = trial.u_new, trial.fu_new
    term_norms = host["term"]

    ls_failed = shrink_exceeded = False
    accepted = True
    tr_state, ls_state = carry.tr_state, carry.ls_state
    glob = alg.globalization
    if glob == "linesearch":
        ls_failed = not trial.ls_res.success
        stats = stats.incr(nf=trial.ls_res.nf + 1)
        ls_state = lsr.ls_post_step(alg.linesearch, trial.ls_res.state,
                                    host["ls_post"])
    elif glob == "trustregion":
        accepted, tr_state = trg.tr_update(alg.trustregion, tr_state,
                                           host["tr"], result, result.du)
        stats = stats.incr(nf=1)
        if not accepted:
            u_new, fu_new, term_norms = u, fu, host["term_old"]
        counter = trg.tr_shrink_counter(tr_state)
        if counter is not None:
            shrink_exceeded = counter > alg.max_shrink_times
    else:
        stats = stats.incr(nf=1)

    # keep the old iterate when the descent was rejected (the geodesic
    # accept test); the termination check counts only when it succeeded
    ctx.mark("other")
    if not descent_ok:
        u_new, fu_new = u, fu
        stop, term = False, carry.term
    else:
        stop, term = trm.check_termination(
            term_cfg, carry.term, fu_new, u_new, u, abstol, reltol,
            norms=term_norms, is_least_squares=ctx.is_least_squares)

    # LM's λ update keyed on trust-region and descent acceptance
    descent_state = dsc.descent_post_step(alg.descent, trial.descent_state,
                                          accepted and success)

    # retcode priority: termination wins over a line-search failure or the
    # shrink limit; a linear-solve failure wins over everything
    retcode = int(ReturnCode.Default)
    if shrink_exceeded:
        retcode = int(ReturnCode.ShrinkThresholdExceeded)
    if ls_failed:
        retcode = int(ReturnCode.InternalLineSearchFailed)
    if stop:
        retcode = term.retcode
    if not linsolve_ok:
        retcode = int(ReturnCode.InternalLinearSolveFailed)
    traced_emit(ctx.verbosity, "termination_condition", stop,
                "termination condition met at step {n} (retcode {rc})",
                n=carry.nsteps + 1, rc=term.retcode)

    if alg.forcing is not None:
        # ‖fu_new‖ of the iterate kept; a kept old iterate has the old norm
        kept_new = descent_ok and accepted
        rnorm = host["rnorm"][0] if kept_new else forcing_state.rnorm
        forcing_state = ForcingState(eta=forcing_state.eta, rnorm=rnorm,
                                     rnorm_prev=forcing_state.rnorm)

    return FOCarry(
        u=u_new, fu=fu_new, nsteps=carry.nsteps + 1,
        force_stop=(stop or ls_failed or shrink_exceeded
                    or not linsolve_ok),
        retcode=retcode, stats=stats, term=term,
        descent_state=descent_state, tr_state=tr_state, ls_state=ls_state,
        forcing_state=forcing_state,
        njvp=carry.njvp + result.njvp,
        krylov_iters=carry.krylov_iters + result.krylov_iters,
        exact_fallbacks=bool(host.get("fell_back")),
        trace_state=record_trace(ctx.trace, carry.trace_state,
                                 carry.nsteps + 1, fu_new, result.du, J,
                                 u_new))


def run_first_order(alg: GeneralizedFirstOrderAlgorithm, ctx: dsc.DescentCtx,
                    term_cfg: trm.TerminationCondition, jac_spec, u0,
                    abstol, reltol, maxiters):
    """init + loop to completion.  Returns the final carry."""
    jac_fn, _kind = construct_jacobian(alg.jacobian, alg.get_linsolve(), ctx,
                                       jac_spec, alg.concrete_jac)
    carry = init_first_order(alg, ctx, term_cfg, u0, reltol)
    while not carry.force_stop and carry.nsteps < maxiters:
        carry = step_first_order(alg, ctx, term_cfg, jac_fn, carry, abstol,
                                 reltol)
    return finalize_first_order(ctx, term_cfg, carry, maxiters)


def finalize_first_order(ctx, term_cfg, carry: FOCarry, maxiters):
    """The end of a run from ``carry``."""
    ctx.mark("other")

    # _run_cache_to_completion! (solve.jl:360-384): Default → MaxIters or
    # Success, then the safe-best iterate with f re-evaluated at it.
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
    return carry.replace(u=u_final, fu=fu_final, retcode=retcode)

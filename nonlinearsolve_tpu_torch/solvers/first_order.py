"""GeneralizedFirstOrderAlgorithm — the Newton-family engine (the port of
``solvers/first_order.py``): ``NewtonRaphson`` with Eisenstat–Walker
forcing and no globalization.  Line-search and trust-region branches are
ROADMAP A.12 / A.13.

The JAX engine's ``lax.while_loop`` becomes a Python loop over device
tensors.  Each step reads the device once for its own decisions (the
linear solve's finiteness, the termination norms and ‖fu‖ for the forcing
term, in one ``_backend.fetch``); GMRES adds its own reads.  The forcing
term and the termination logic run on the host in the working dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from .. import _backend
from ..core import descent as dsc
from ..core import termination as trm
from ..core.autodiff import JacobianPolicy
from ..core.jacobian import construct_jacobian
from ..core.returncode import ReturnCode
from ..core.solution import NLStats
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
    name: str = "GeneralizedFirstOrder"

    def __post_init__(self):
        if self.linesearch is not None and self.trustregion is not None:
            raise ValueError("cannot combine linesearch and trustregion "
                             "globalization")

    def get_linsolve(self):
        return getattr(self.descent, "linsolve", None)

    @property
    def globalization(self) -> str:
        if self.linesearch is not None:
            return "linesearch"
        if self.trustregion is not None:
            return "trustregion"
        return "none"


def NewtonRaphson(*, linsolve=None, linesearch=None, autodiff=None,
                  forcing=None, concrete_jac=None):
    """raphson.jl:30-43."""
    from ..ops.linear_solve import LinearSolver
    ls = linsolve if linsolve is not None else LinearSolver()
    return GeneralizedFirstOrderAlgorithm(
        descent=dsc.NewtonDescent(linsolve=ls), linesearch=linesearch,
        jacobian=autodiff or JacobianPolicy(), forcing=forcing,
        concrete_jac=concrete_jac, name="NewtonRaphson")


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
    forcing_state: Optional[ForcingState]
    njvp: int = 0
    krylov_iters: int = 0

    def replace(self, **kw) -> "FOCarry":
        return dataclasses.replace(self, **kw)


def init_first_order(alg: GeneralizedFirstOrderAlgorithm, ctx: dsc.DescentCtx,
                     term_cfg: trm.TerminationCondition, u0, reltol):
    if alg.globalization != "none":
        item = "A.12" if alg.globalization == "linesearch" else "A.13"
        raise NotImplementedError(
            f"{alg.globalization} globalization is ROADMAP {item}")
    fu0 = ctx.f_flat(u0)
    wanted = trm.termination_norms(term_cfg, fu0)
    if alg.forcing is not None:
        wanted.append(l2_norm(fu0))
    host = _backend.fetch(*wanted)
    term = trm.init_termination(term_cfg, fu0, u0, reltol, norms=host)
    forcing_state = None
    if alg.forcing is not None:
        eta_0 = _backend.np_dtype(u0.dtype)(alg.forcing.eta_0)
        forcing_state = ForcingState(eta=eta_0, rnorm=host[-1],
                                     rnorm_prev=host[-1])
    return FOCarry(
        u=u0, fu=fu0, nsteps=0,
        force_stop=False, retcode=int(ReturnCode.Default),
        stats=NLStats.zeros().incr(nf=1), term=term,
        descent_state=dsc.descent_init(alg.descent, ctx, None, fu0, u0),
        forcing_state=forcing_state)


def _forcing_eta(fcfg: EisenstatWalkerForcing, fs: ForcingState, nsteps: int,
                 npdt):
    """Eisenstat–Walker pre-step (eisenstat_walker.jl:44-85), in the
    working dtype."""
    if nsteps == 0:
        return npdt(fcfg.eta_0)
    eta_new = npdt(fcfg.gamma) * (fs.rnorm / fs.rnorm_prev) ** npdt(fcfg.alpha)
    if fcfg.safeguard:
        eta_sg = npdt(fcfg.gamma) * fs.eta ** npdt(fcfg.alpha)
        if eta_sg > npdt(fcfg.safeguard_threshold) and eta_sg > eta_new:
            eta_new = eta_sg
    return npdt(np.clip(eta_new, npdt(0), npdt(fcfg.eta_max)))


def step_first_order(alg: GeneralizedFirstOrderAlgorithm,
                     ctx: dsc.DescentCtx, term_cfg: trm.TerminationCondition,
                     jac_fn, carry: FOCarry, abstol, reltol) -> FOCarry:
    """One iteration (solve.jl:298-426), no globalization."""
    u, fu = carry.u, carry.fu
    npdt = _backend.np_dtype(u.dtype)
    J = jac_fn(u)
    stats = carry.stats.incr(njacs=1, nsteps=1)

    krylov_rtol = None
    forcing_state = carry.forcing_state
    if alg.forcing is not None:
        eta = _forcing_eta(alg.forcing, forcing_state, carry.nsteps, npdt)
        forcing_state = dataclasses.replace(forcing_state, eta=eta)
        krylov_rtol = eta

    result, descent_state = dsc.descent_solve(
        alg.descent, carry.descent_state, ctx, J, fu, u,
        krylov_rtol=krylov_rtol)
    stats = stats.incr(nf=result.nf, nsolve=result.nsolve,
                       nfactors=result.nfactors)
    u_new = u + result.du
    fu_new = ctx.f_flat(u_new)
    stats = stats.incr(nf=1)

    # One host read for the whole step: the linear solve's finiteness, the
    # termination norms and (for the forcing term) ‖fu_new‖.
    wanted = [result.linsolve_success.to(u.dtype),
              *trm.termination_norms(term_cfg, fu_new, u_new, u)]
    if alg.forcing is not None:
        wanted.append(l2_norm(fu_new))
    host = _backend.fetch(*wanted)
    linsolve_ok = bool(host[0])
    n_term = len(wanted) - 1 - (alg.forcing is not None)
    if linsolve_ok:
        # Keep the old iterate when the descent was rejected; the
        # termination check only counts when it succeeded (solve.jl:410).
        stop, term = trm.check_termination(
            term_cfg, carry.term, fu_new, u_new, u, abstol, reltol,
            norms=host[1:1 + n_term])
    else:
        u_new, fu_new = u, fu
        stop, term = False, carry.term

    # Retcode priority: a linear-solve failure wins over termination.
    if not linsolve_ok:
        retcode = int(ReturnCode.InternalLinearSolveFailed)
    else:
        retcode = term.retcode if stop else int(ReturnCode.Default)

    if alg.forcing is not None:
        rnorm = host[-1] if linsolve_ok else forcing_state.rnorm
        forcing_state = ForcingState(eta=forcing_state.eta, rnorm=rnorm,
                                     rnorm_prev=forcing_state.rnorm)

    return FOCarry(
        u=u_new, fu=fu_new, nsteps=carry.nsteps + 1,
        force_stop=stop or not linsolve_ok, retcode=retcode, stats=stats, term=term, descent_state=descent_state,
        forcing_state=forcing_state,
        njvp=carry.njvp + result.njvp,
        krylov_iters=carry.krylov_iters + result.krylov_iters)


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

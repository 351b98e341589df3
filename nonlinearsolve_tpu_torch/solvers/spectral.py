"""GeneralizedDFSane — the Jacobian-free spectral engine (the port of
``solvers/spectral.py``): the step ``δu = -σ fu`` under the robust
non-monotone line search, with the Barzilai–Borwein update
``σ = ⟨Δu, Δu⟩ / ⟨Δu, Δfu⟩``, replaced by ``clamp(1/‖fu‖, 1, 1e5)``
outside ``[σ_min, σ_max]`` (solve.jl:269-290).

σ stays on the device; the line search reads once a trial, and the step
once more for the termination and the search's history (the engine
pattern of ``first_order.py``).  The engine runs on the flattened state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..core import linesearch as lsr
from ..core import termination as trm
from ..core.returncode import ReturnCode
from ..core.solution import NLStats
from ..core.tracing import init_trace, record_trace
from ..utils.norms import l2_norm, tree_dot
from .first_order import _read_groups
from .quasi_newton import finish, flat_ctx


@dataclasses.dataclass(frozen=True)
class GeneralizedDFSane:
    linesearch: Any = lsr.RobustNonMonotoneLineSearch()
    sigma_min: float = 1e-10
    sigma_max: float = 1e10
    sigma_1: Optional[float] = None
    name: str = "GeneralizedDFSane"


def DFSane(*, sigma_min: float = 1e-10, sigma_max: float = 1e10,
           sigma_1: float = 1.0, M: int = 10, gamma: float = 1e-4,
           tau_min: float = 0.1, tau_max: float = 0.5, n_exp: int = 2,
           max_inner_iterations: int = 100):
    """dfsane.jl:22-35: the engine's σ starts adaptive (``sigma_1`` is the
    line search's first step)."""
    return GeneralizedDFSane(
        linesearch=lsr.RobustNonMonotoneLineSearch(
            gamma=gamma, sigma_1=sigma_1, M=M, tau_min=tau_min,
            tau_max=tau_max, n_exp=n_exp, maxiters=max_inner_iterations),
        sigma_min=sigma_min, sigma_max=sigma_max, sigma_1=None,
        name="DFSane")


@dataclasses.dataclass(frozen=True)
class DFSaneCarry:
    u: Any
    fu: Any
    sigma: Any                  # 0-d device tensor
    nsteps: int
    force_stop: bool
    retcode: int
    stats: NLStats
    term: trm.TermState
    ls_state: Any
    njvp: int = 0
    krylov_iters: int = 0
    trace_state: Any = None

    def replace(self, **kw) -> "DFSaneCarry":
        return dataclasses.replace(self, **kw)


def _spectral(alg: GeneralizedDFSane, num, denom, fu):
    """⟨s,s⟩/⟨s,y⟩, or the fallback outside [σ_min, σ_max]."""
    sigma = num / torch.where(denom == 0, torch.ones_like(denom), denom)
    fallback = torch.clamp(1.0 / l2_norm(fu), 1.0, 1e5)
    in_bounds = ((alg.sigma_min <= sigma.abs())
                 & (sigma.abs() <= alg.sigma_max)
                 & (denom != 0) & torch.isfinite(sigma))
    return torch.where(in_bounds, sigma, fallback)


def _initial_sigma(alg: GeneralizedDFSane, u, fu):
    """solve.jl:205-214: σ = ⟨u,u⟩/⟨u,fu⟩ with the same fallback."""
    if alg.sigma_1 is not None:
        return torch.as_tensor(alg.sigma_1, dtype=u.dtype, device=u.device)
    return _spectral(alg, tree_dot(u, u), tree_dot(u, fu), fu)


def init_dfsane(alg: GeneralizedDFSane, ctx, term_cfg, u0,
                reltol) -> DFSaneCarry:
    fu0 = ctx.f_flat(u0)
    host = _read_groups({"term": trm.init_norms(term_cfg, fu0, u0),
                         "ls": lsr.ls_init_reads(alg.linesearch, fu0)})
    return DFSaneCarry(
        u=u0, fu=fu0, sigma=_initial_sigma(alg, u0, fu0), nsteps=0,
        force_stop=False, retcode=int(ReturnCode.Default),
        stats=NLStats.zeros().incr(nf=1),
        term=trm.init_termination(term_cfg, fu0, u0, reltol,
                                  norms=host["term"]),
        ls_state=lsr.ls_init(alg.linesearch, fu0, host["ls"]),
        trace_state=init_trace(ctx.trace, u0))


def step_dfsane(alg: GeneralizedDFSane, ctx, term_cfg, carry: DFSaneCarry,
                abstol, reltol) -> DFSaneCarry:
    u, fu = carry.u, carry.fu
    du = -carry.sigma * fu
    ls_res = lsr.ls_solve(alg.linesearch, carry.ls_state, ctx, u, du, fu,
                          None, carry.nsteps)
    u_new = lsr.at(u, ls_res.alpha, du)
    fu_new = ctx.f_flat(u_new)
    stats = carry.stats.incr(nf=ls_res.nf + 1, nsteps=1)
    if ctx.postcondition is not None:
        u_new = ctx.postcondition(u_new, u)
        fu_new = ctx.f_flat(u_new)
        stats = stats.incr(nf=1)
    host = _read_groups({
        "term": trm.termination_norms(term_cfg, fu_new, u_new, u,
                                      abstol=abstol, reltol=reltol),
        "ls_post": lsr.ls_post_reads(alg.linesearch, fu_new)})
    ls_state = lsr.ls_post_step(alg.linesearch, ls_res.state,
                                host["ls_post"])
    stop, term = trm.check_termination(
        term_cfg, carry.term, fu_new, u_new, u, abstol, reltol,
        norms=host["term"], is_least_squares=ctx.is_least_squares)

    # the spectral parameter (solve.jl:269-287)
    s, y = u_new - u, fu_new - fu
    sigma = _spectral(alg, tree_dot(s, s), tree_dot(s, y), fu_new)

    ls_failed = not ls_res.success
    retcode = int(ReturnCode.Default)
    if ls_failed:
        retcode = int(ReturnCode.InternalLineSearchFailed)
    if stop:
        retcode = term.retcode
    return DFSaneCarry(
        u=u_new, fu=fu_new, sigma=sigma, nsteps=carry.nsteps + 1,
        force_stop=stop or ls_failed, retcode=retcode, stats=stats,
        term=term, ls_state=ls_state,
        trace_state=record_trace(ctx.trace, carry.trace_state,
                                 carry.nsteps + 1, fu_new,
                                 ls_res.alpha * du, None, u_new))


def run_dfsane(alg: GeneralizedDFSane, ctx, term_cfg, u0, abstol, reltol,
               maxiters):
    """init + loop to completion on the flattened state."""
    shape = u0.shape
    fctx, seen = flat_ctx(ctx, shape)
    carry = init_dfsane(alg, fctx, term_cfg, u0.reshape(-1), reltol)
    while not carry.force_stop and carry.nsteps < maxiters:
        carry = step_dfsane(alg, fctx, term_cfg, carry, abstol, reltol)
    return finish(carry, fctx, term_cfg, maxiters, shape, seen)


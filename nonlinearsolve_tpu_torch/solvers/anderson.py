"""Anderson acceleration (the port of ``solvers/anderson.py``): Walker & Ni
(2011) type-II Anderson on the fixed-point map ``g(u) = u + β f(u)`` with
ring buffers ``dU`` / ``dF`` of the last ``m`` state and residual
differences, and the per-step least squares ``min_γ ‖F − dFᵀγ‖`` solved as
Tikhonov-regularized m×m normal equations (``_square_solve``: Gauss–Jordan
for m ≤ 32, one CUDA graph a shape on the card).  For a genuine fixed
point ``u = g(u)`` pass ``f(u) = g(u) − u``.

One host read a step (the termination); the ring's fill count is a host
int.  The engine runs on the flattened state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..core import termination as trm
from ..core.returncode import ReturnCode
from ..core.solution import NLStats
from ..core.tracing import init_trace, record_trace
from ..ops.linear_solve import _square_solve
from ..utils import ordering
from .quasi_newton import finish, flat_ctx


@dataclasses.dataclass(frozen=True)
class AndersonAcceleration:
    """``m``: history depth; ``beta``: mixing; ``regularization``: the
    Tikhonov λ of the normal equations (scaled by the trace)."""

    m: int = 5
    beta: float = 1.0
    regularization: float = 1e-10
    name: str = "AndersonAcceleration"


@dataclasses.dataclass(frozen=True)
class AndersonCarry:
    u: Any
    fu: Any
    dU: Any          # (m, n) state differences ring
    dF: Any          # (m, n) residual differences ring
    count: int       # updates written
    nsteps: int
    force_stop: bool
    retcode: int
    stats: NLStats
    term: trm.TermState
    njvp: int = 0
    krylov_iters: int = 0
    trace_state: Any = None

    def replace(self, **kw) -> "AndersonCarry":
        return dataclasses.replace(self, **kw)


def _anderson_gamma(dF, fu, hist_mask, reg):
    """Solve the masked normal equations (dF dFᵀ + λI) γ = dF fu.  Rows
    without history are masked to zero with 1 on the diagonal, so γ is 0
    there."""
    m = dF.shape[0]
    eye = torch.eye(m, dtype=dF.dtype, device=dF.device)
    dFm = dF * hist_mask[:, None]
    G = dFm @ dFm.T
    lam = reg * (torch.trace(G) + 1.0)
    G = G + lam * eye
    G = torch.where(ordering.greater(hist_mask[:, None] * hist_mask[None, :],
                                     0), G, eye)
    rhs = (dFm @ fu) * hist_mask
    gamma = _square_solve(G, rhs)
    return torch.where(torch.isfinite(gamma), gamma,
                       torch.zeros_like(gamma))


def init_anderson(alg: AndersonAcceleration, ctx, term_cfg, u0,
                  reltol) -> AndersonCarry:
    fu0 = ctx.f_flat(u0)
    n = u0.shape[0]
    m = min(alg.m, n)
    zeros = torch.zeros((m, n), dtype=u0.dtype, device=u0.device)
    return AndersonCarry(
        u=u0, fu=fu0, dU=zeros, dF=zeros.clone(), count=0, nsteps=0,
        force_stop=False, retcode=int(ReturnCode.Default),
        stats=NLStats.zeros().incr(nf=1),
        term=trm.init_termination(term_cfg, fu0, u0, reltol),
        trace_state=init_trace(ctx.trace, u0))


def step_anderson(alg: AndersonAcceleration, ctx, term_cfg,
                  carry: AndersonCarry, abstol, reltol) -> AndersonCarry:
    u, fu = carry.u, carry.fu
    m = carry.dU.shape[0]
    hist = min(carry.count, m)
    hist_mask = (torch.arange(m, device=u.device) < hist).to(u.dtype)
    gamma = _anderson_gamma(carry.dF, fu, hist_mask,
                            torch.as_tensor(alg.regularization,
                                            dtype=u.dtype, device=u.device))
    # u⁺ = u + βF − (dU + β dF)ᵀ γ  (Walker–Ni type II)
    beta = float(alg.beta)
    u_new = (torch.add(u, fu, alpha=beta)
             - torch.add(carry.dU, carry.dF, alpha=beta).T @ gamma)
    fu_new = ctx.f_flat(u_new)
    stats = carry.stats.incr(nf=1, nsteps=1)
    if ctx.postcondition is not None:
        u_new = ctx.postcondition(u_new, u)
        fu_new = ctx.f_flat(u_new)
        stats = stats.incr(nf=1)

    # the ring takes the new (Δu, ΔF) pair
    slot = carry.count % m
    dU, dF = carry.dU.clone(), carry.dF.clone()
    dU[slot] = u_new - u
    dF[slot] = fu_new - fu

    stop, term = trm.check_termination(
        term_cfg, carry.term, fu_new, u_new, u, abstol, reltol,
        is_least_squares=ctx.is_least_squares)
    return AndersonCarry(
        u=u_new, fu=fu_new, dU=dU, dF=dF, count=carry.count + 1,
        nsteps=carry.nsteps + 1, force_stop=stop,
        retcode=term.retcode if stop else int(ReturnCode.Default),
        stats=stats, term=term,
        trace_state=record_trace(ctx.trace, carry.trace_state,
                                 carry.nsteps + 1, fu_new, u_new - u, None,
                                 u_new))


def run_anderson(alg: AndersonAcceleration, ctx, term_cfg, u0, abstol,
                 reltol, maxiters):
    """init + loop to completion on the flattened state."""
    shape = u0.shape
    fctx, seen = flat_ctx(ctx, shape)
    carry = init_anderson(alg, fctx, term_cfg, u0.reshape(-1), reltol)
    while not carry.force_stop and carry.nsteps < maxiters:
        carry = step_anderson(alg, fctx, term_cfg, carry, abstol, reltol)
    return finish(carry, fctx, term_cfg, maxiters, shape, seen)

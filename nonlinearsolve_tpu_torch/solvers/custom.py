"""User-defined algorithms (the port of ``solvers/custom.py``).

Any object with a ``run_flat`` method runs as an algorithm:

    class MySolver:
        name = "MySolver"
        def run_flat(self, ctx, term_cfg, u0_flat, abstol, reltol,
                     maxiters) -> carry

``ctx.f_flat(u) -> fu`` is the residual on the flattened state;
``abstol`` / ``reltol`` are host scalars of the state's dtype and
``maxiters`` an int.  The returned carry exposes u / fu / retcode / stats
/ nsteps (``make_custom_carry`` assembles one); ``run_fixed_point_loop``
drives a solver written as ``u_next, state = step(u, fu, state)`` with the
standard termination checks, one host read a step.  A solve through a user
algorithm is differentiable in ``p`` by the implicit-function rule, as
every other engine's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..core import termination as trm
from ..core.returncode import ReturnCode
from ..core.solution import NLStats


@dataclasses.dataclass(frozen=True)
class CustomCarry:
    u: Any
    fu: Any
    nsteps: int
    force_stop: bool
    retcode: int
    stats: NLStats
    term: Any
    state: Any = None

    def replace(self, **kw) -> "CustomCarry":
        return dataclasses.replace(self, **kw)


def make_custom_carry(u, fu, *, retcode=None, stats=None, nsteps=0,
                      term=None, state=None) -> CustomCarry:
    return CustomCarry(
        u=u, fu=fu, nsteps=int(nsteps), force_stop=False,
        retcode=int(ReturnCode.Default) if retcode is None else int(retcode),
        stats=NLStats.zeros() if stats is None else stats,
        term=term, state=state)


def run_fixed_point_loop(step: Callable, ctx, term_cfg, u0_flat, abstol,
                         reltol, maxiters, *, state0=None) -> CustomCarry:
    """Drive ``u_next, state_next = step(u, fu, state)`` to convergence
    with the standard termination checks and return codes."""
    fu0 = ctx.f_flat(u0_flat)
    term = trm.init_termination(term_cfg, fu0, u0_flat, reltol)
    c = make_custom_carry(u0_flat, fu0, term=term, state=state0,
                          stats=NLStats.zeros().incr(nf=1))
    while not c.force_stop and c.nsteps < maxiters:
        u_new, state_new = step(c.u, c.fu, c.state)
        fu_new = ctx.f_flat(u_new)
        stop, term = trm.check_termination(
            term_cfg, c.term, fu_new, u_new, c.u, abstol, reltol,
            is_least_squares=ctx.is_least_squares)
        c = CustomCarry(
            u=u_new, fu=fu_new, nsteps=c.nsteps + 1, force_stop=stop,
            retcode=term.retcode if stop else c.retcode,
            stats=c.stats.incr(nf=1, nsteps=1), term=term, state=state_new)
    retcode = c.retcode
    if retcode == ReturnCode.Default:
        retcode = int(ReturnCode.MaxIters if c.nsteps >= maxiters
                      else ReturnCode.Success)
    u_final = trm.termination_result(term_cfg, c.term, c.u)
    fu_final = ctx.f_flat(u_final) if term_cfg.keeps_best else c.fu
    return c.replace(u=u_final, fu=fu_final, retcode=retcode)


def run_custom(alg, ctx, term_cfg, u0, abstol, reltol, maxiters):
    """``alg.run_flat`` on the flattened state; the carry's ``u`` and
    ``fu`` back in their shapes."""
    from .quasi_newton import flat_ctx
    shape = u0.shape
    fctx, seen = flat_ctx(ctx, shape)
    carry = alg.run_flat(fctx, term_cfg, u0.reshape(-1), abstol, reltol,
                         maxiters)
    return dataclasses.replace(
        carry, u=carry.u.reshape(shape),
        fu=carry.fu.reshape(seen.get("fu", (-1,))))

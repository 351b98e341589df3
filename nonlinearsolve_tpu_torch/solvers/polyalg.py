"""Polyalgorithms and the default ladders (the port of
``solvers/polyalg.py``).

``run_polyalg`` runs the rungs in order, each from ``u0`` with the full
``maxiters``, until one returns a successful code; the rungs' stats are
summed.  When every rung fails it returns the iterate with the smallest
finite ‖fu‖₂ (a strict ``<``, so the first such rung wins a tie) with
that rung's code.  The JAX package runs each rung under a ``lax.cond`` on
"no success yet"; here that is a host decision, and a rung's ‖fu‖ costs
one read.

Default ladders: ``FastShortcutNonlinearPolyalg`` (Broyden → Klement →
NewtonRaphson → TrustRegion → TrustRegion(Fan) → LevenbergMarquardt, from
the third rung when ``u0_len ≤ 25``; SimpleBroyden → SimpleKlement first
with ``prefer_simplenonlinearsolve``; NewtonRaphson → TrustRegion →
TrustRegion(Fan) → LevenbergMarquardt with ``must_use_jacobian``; the two
reduced ladders for complex states), ``RobustMultiNewton`` and
``FastShortcutNLLSPolyalg``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np

from .. import _backend
from ..core.returncode import ReturnCode
from ..core.solution import NLStats
from ..utils.norms import l2_norm


@dataclasses.dataclass(frozen=True)
class NonlinearSolvePolyAlgorithm:
    algs: Tuple[Any, ...] = ()
    start_index: int = 1          # 1-based, as in the reference
    name: str = "PolyAlgorithm"


def FastShortcutNonlinearPolyalg(*, autodiff=None, linsolve=None,
                                 must_use_jacobian: bool = False,
                                 prefer_simplenonlinearsolve: bool = False,
                                 u0_len: Optional[int] = None,
                                 complex_eltype: bool = False):
    """poly_algs.jl:26-92; ``complex_eltype`` selects the reduced complex
    ladders."""
    from .first_order import LevenbergMarquardt, NewtonRaphson, TrustRegion
    from .quasi_newton import Broyden, Klement
    kw = dict(autodiff=autodiff)
    if complex_eltype:
        if must_use_jacobian:
            algs = (NewtonRaphson(**kw),)
        else:
            algs = (Broyden(autodiff=autodiff), Klement(autodiff=autodiff),
                    NewtonRaphson(**kw))
        return NonlinearSolvePolyAlgorithm(
            algs=algs, name="FastShortcutNonlinearPolyalg")
    if must_use_jacobian:
        algs = (NewtonRaphson(**kw), TrustRegion(**kw),
                TrustRegion(radius_update_scheme="fan", **kw),
                LevenbergMarquardt(**kw))
        return NonlinearSolvePolyAlgorithm(
            algs=algs, name="FastShortcutNonlinearPolyalg")
    if prefer_simplenonlinearsolve:
        from .simple import SimpleBroyden, SimpleKlement
        first, second = SimpleBroyden(), SimpleKlement()
    else:
        first, second = Broyden(autodiff=autodiff), Klement(autodiff=autodiff)
    start_index = 3 if (u0_len is not None and u0_len <= 25) else 1
    algs = (first, second,
            NewtonRaphson(**kw), TrustRegion(**kw),
            TrustRegion(radius_update_scheme="fan", **kw),
            LevenbergMarquardt(**kw))
    return NonlinearSolvePolyAlgorithm(algs=algs, start_index=start_index,
                                       name="FastShortcutNonlinearPolyalg")


def RobustMultiNewton(*, autodiff=None, linsolve=None):
    """FirstOrder poly_algs.jl:22-44."""
    from ..core.linesearch import BackTracking
    from .first_order import NewtonRaphson, TrustRegion
    kw = dict(autodiff=autodiff)
    algs = (TrustRegion(**kw),
            TrustRegion(radius_update_scheme="bastin", **kw),
            NewtonRaphson(**kw),
            NewtonRaphson(linesearch=BackTracking(), **kw),
            TrustRegion(radius_update_scheme="nlsolve", **kw),
            TrustRegion(radius_update_scheme="fan", **kw))
    return NonlinearSolvePolyAlgorithm(algs=algs, name="RobustMultiNewton")


def FastShortcutNLLSPolyalg(*, autodiff=None, linsolve=None):
    """FirstOrder poly_algs.jl:62-88."""
    from ..core.linesearch import BackTracking
    from .first_order import GaussNewton, LevenbergMarquardt, TrustRegion
    kw = dict(autodiff=autodiff)
    algs = (GaussNewton(**kw),
            LevenbergMarquardt(disable_geodesic=True, **kw),
            TrustRegion(**kw),
            GaussNewton(linesearch=BackTracking(), **kw),
            TrustRegion(radius_update_scheme="fan", **kw),
            LevenbergMarquardt(**kw))
    return NonlinearSolvePolyAlgorithm(algs=algs,
                                       name="FastShortcutNLLSPolyalg")


@dataclasses.dataclass(frozen=True)
class PolyCarry:
    u: Any
    fu: Any
    retcode: int
    stats: NLStats
    done: bool
    best_u: Any
    best_fu: Any
    best_resid: Any              # host scalar
    best_retcode: int
    winner: int                  # index of the rung that succeeded, or -1
    rungs: tuple = ()            # (index, retcode, nsteps) of each run
    njvp: int = 0
    krylov_iters: int = 0

    def replace(self, **kw) -> "PolyCarry":
        return dataclasses.replace(self, **kw)


def run_polyalg(alg: NonlinearSolvePolyAlgorithm, ctx, term_cfg, jac_spec,
                u0, abstol, reltol, maxiters, start_hint=None):
    """Run the ladder from ``start_index``; ``winner`` is the index (from
    0) of the rung that succeeded.  ``start_hint`` is the best-rung
    retention of warm restarts: the rungs before it are skipped on a first
    pass and run only in a second, wrap-around pass, if no rung from the
    hint on succeeded."""
    from .dispatch import run_algorithm

    rungs = list(enumerate(alg.algs))[alg.start_index - 1:]
    if start_hint is not None:
        hint = max(int(start_hint), alg.start_index - 1)
        rungs = ([r for r in rungs if r[0] >= hint]
                 + [r for r in rungs if r[0] < hint])
    fu0 = ctx.f_flat(u0)
    npdt = _backend.real_np_dtype(u0.dtype)
    carry = PolyCarry(
        u=u0, fu=fu0, retcode=int(ReturnCode.Default),
        stats=NLStats.zeros(), done=False, best_u=u0, best_fu=fu0,
        best_resid=npdt(np.inf), best_retcode=int(ReturnCode.Failure),
        winner=-1)
    for idx, sub in rungs:
        if carry.done:
            break
        final = run_algorithm(sub, ctx, term_cfg, jac_spec, u0, abstol,
                              reltol, maxiters)
        success = ReturnCode.successful(final.retcode)
        resid, = _backend.fetch(l2_norm(final.fu))
        better = bool(resid < carry.best_resid and np.isfinite(resid))
        s = final.stats
        carry = carry.replace(
            stats=carry.stats.incr(nf=s.nf, njacs=s.njacs,
                                   nfactors=s.nfactors, nsolve=s.nsolve,
                                   nsteps=s.nsteps),
            rungs=carry.rungs + ((idx, int(final.retcode), s.nsteps),),
            njvp=carry.njvp + getattr(final, "njvp", 0),
            krylov_iters=carry.krylov_iters + getattr(final, "krylov_iters",
                                                      0))
        if success:
            carry = carry.replace(u=final.u, fu=final.fu,
                                  retcode=int(final.retcode), done=True,
                                  winner=idx)
        if better:
            carry = carry.replace(best_u=final.u, best_fu=final.fu,
                                  best_resid=resid,
                                  best_retcode=int(final.retcode))
    if carry.done:
        return carry
    # every rung failed: the lowest-residual iterate with its code
    return carry.replace(u=carry.best_u, fu=carry.best_fu,
                         retcode=carry.best_retcode)

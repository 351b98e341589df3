"""The initialization hook (the port of ``core/initialization.py``).

When a problem's function carries ``initialization_data``, a sub-problem
(consistent algebraic states, say) is solved first and its solution is
mapped onto the main problem's ``u0`` and ``p``.  If the sub-solve fails,
the main solve is aborted with ``ReturnCode.InitialFailure``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from .returncode import ReturnCode
from .solution import NonlinearSolution


@dataclasses.dataclass(frozen=True, eq=False)
class InitializationData:
    """``initializeprob``: the sub-problem solved before the main solve.

    ``initializeprobmap(init_sol) -> u0`` maps the sub-solution onto the
    main problem's state (None keeps ``u0``); ``initializeprobpmap(init_sol,
    p) -> p`` updates the parameters (None keeps them); ``alg`` overrides
    the sub-solver, ``abstol`` its tolerance."""

    initializeprob: Any
    initializeprobmap: Optional[Callable] = None
    initializeprobpmap: Optional[Callable] = None
    alg: Any = None
    abstol: Optional[float] = None


def run_initialization(prob, data: InitializationData):
    """Solve the sub-problem and remap (u0, p); returns ``(prob', init_sol,
    ok)``, ``prob'`` with the mapped u0 and p."""
    from .solve import solve

    kwargs = {} if data.abstol is None else {"abstol": data.abstol}
    init_sol = solve(data.initializeprob, data.alg, **kwargs)
    if not init_sol.success:
        return prob, init_sol, False
    u0 = (data.initializeprobmap(init_sol)
          if data.initializeprobmap is not None else prob.u0)
    p = (data.initializeprobpmap(init_sol, prob.p)
         if data.initializeprobpmap is not None else prob.p)
    return prob.remake(u0=u0, p=p), init_sol, True


def initial_failure_solution(prob, init_sol) -> NonlinearSolution:
    """The aborted solve: ``u0``, f(u0), ``InitialFailure``, and the
    sub-solution as ``original``."""
    return NonlinearSolution(
        u=prob.u0, resid=prob.f.f(prob.u0, prob.p),
        retcode=ReturnCode.InitialFailure, stats=None,
        counters={"jvp": 0, "krylov_iters": 0, "host_syncs": 0},
        original=init_sol)

"""The SCC (strongly connected component) solver (the port of
``solvers/scc.py``).

``solve_scc`` solves an ordered sequence of blocks — nonlinear, linear
(``LinearSCCBlock``) or homotopy — where each block's parameters may be
computed from the blocks already solved by ``explicitfuns``; ``u`` and
``resid`` are the blocks' flattened values one after another, the stats
their sum, and the retcode ``Success`` when every block succeeded, else the
first failing block's.

Derivatives flow from block to block: a block's root is joined to its
parameters by the implicit-function rule (``core/sensitivity.py``), so a
parameter computed from an earlier block's solution carries that block's
derivative on.  A linear block's ``A u = b`` is joined to ``A`` and ``b`` by
the same rule (its solve itself is ``solve_dense``: Gauss–Jordan up to 32
unknowns, LU above, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from .. import _backend
from ..core.problems import HomotopyProblem, SCCNonlinearProblem
from ..core.returncode import ReturnCode
from ..core.solution import NLStats, NonlinearSolution


@dataclasses.dataclass(frozen=True)
class SCCAlg:
    """The SCC entry point's algorithm: ``nlalg`` solves the nonlinear
    blocks (the default polyalgorithm when None), ``linalg`` the linear
    blocks (a ``LinearSolver``), and ``store_original`` keeps the blocks'
    solutions on ``sol.original``."""

    nlalg: Any = None
    linalg: Any = None
    store_original: bool = True


@dataclasses.dataclass(frozen=True)
class LinearSCCBlock:
    """A linear block ``A(p) u = b(p)`` in an SCC sequence."""

    A: Callable       # p_block -> (n, n) matrix
    b: Callable       # p_block -> (n,) right-hand side


def _linear_block(block: LinearSCCBlock, p_block, linalg):
    from ..core.sensitivity import differentiable_leaves, differentiable_root
    from ..ops.linear_solve import LinearSolver, solve_dense
    A, b = block.A(p_block), block.b(p_block)
    with torch.no_grad():
        x, ok = solve_dense(A.detach(), b.detach(),
                            linalg if linalg is not None else LinearSolver())
        ok, = _backend.fetch(ok)
    index = differentiable_leaves((A, b))
    if index:
        x = differentiable_root(x, lambda u, q: q[0] @ u - q[1], (A, b),
                                index, square=True, dense=True)
    return NonlinearSolution(
        u=x, resid=A @ x - b,
        retcode=(ReturnCode.Success if ok
                 else ReturnCode.InternalLinearSolveFailed),
        stats=NLStats.zeros().incr(nsolve=1, nfactors=1))


def solve_scc(prob: SCCNonlinearProblem, alg=None, **kwargs
              ) -> NonlinearSolution:
    """Solve the blocks in order.  ``maxtime`` applies to each block."""
    from ..core.solve import _default_algorithm, solve, solve_nonlinear

    linalg = None
    store_original = True
    if isinstance(alg, SCCAlg):
        linalg = alg.linalg
        store_original = alg.store_original
        alg = alg.nlalg
    maxtime = kwargs.pop("maxtime", None)

    sols, us, resids = [], [], []
    retcode = ReturnCode.Success
    stats = NLStats.zeros()
    for i, block in enumerate(prob.probs):
        if prob.explicitfuns is not None and prob.explicitfuns[i] is not None:
            p_block = prob.explicitfuns[i](prob.p, tuple(sols))
        else:
            p_block = getattr(block, "p", prob.p)

        if isinstance(block, LinearSCCBlock):
            sol = _linear_block(block, p_block, linalg)
        elif isinstance(block, HomotopyProblem):
            # swept by continuation, with the SCC's nonlinear algorithm as
            # the inner corrector
            from .homotopy import (ArcLengthContinuation,
                                   HomotopyPolyAlgorithm, HomotopySweep)
            block_prob = HomotopyProblem(block.f, block.u0, p_block,
                                         lambdaspan=block.lambdaspan,
                                         **block.kwargs)
            block_alg = HomotopyPolyAlgorithm(
                stages=(HomotopySweep(inner=alg),
                        ArcLengthContinuation(inner=alg)))
            sol = solve(block_prob, block_alg, **kwargs)
        else:
            block_prob = (block.remake(p=p_block)
                          if p_block is not getattr(block, "p", None)
                          else block)
            block_alg = (alg if alg is not None
                         else _default_algorithm(block_prob))
            if maxtime is not None:
                sol = solve(block_prob, block_alg, maxtime=maxtime, **kwargs)
            else:
                sol = solve_nonlinear(block_prob, block_alg, **kwargs)

        sols.append(sol)
        us.append(sol.u.reshape(-1))
        resids.append(sol.resid.reshape(-1))
        if (not ReturnCode.successful(sol.retcode)
                and retcode == ReturnCode.Success):
            retcode = ReturnCode(int(sol.retcode))
        stats = stats.incr(nf=sol.stats.nf, njacs=sol.stats.njacs,
                           nfactors=sol.stats.nfactors,
                           nsolve=sol.stats.nsolve, nsteps=sol.stats.nsteps)

    return NonlinearSolution(
        u=torch.cat(us), resid=torch.cat(resids), retcode=retcode,
        stats=stats, original=tuple(sols) if store_original else None)


def scc_solve_up(prob: SCCNonlinearProblem, sensealg=None, u0=None, p=None,
                 alg=None, **kwargs) -> NonlinearSolution:
    """The SCC solve entry with the reference's signature: ``sensealg`` and
    ``u0`` are accepted and ignored (the blocks own their u0; derivatives
    flow through each block's implicit-function rule); a non-None ``p``
    replaces ``prob.p``."""
    del sensealg, u0
    if p is not None:
        prob = SCCNonlinearProblem(probs=prob.probs,
                                   explicitfuns=prob.explicitfuns, p=p)
    return solve_scc(prob, alg, **kwargs)

"""Top-level ``solve`` (the port of ``core/solve.py``).

``solve`` checks the keyword arguments, merges call-site over problem
kwargs and runs ``solve_nonlinear`` on a ``NonlinearProblem`` or a
``NonlinearLeastSquaresProblem``, ``solvers.bracketing.solve_bracketing``
on an ``IntervalNonlinearProblem`` and ``core.ensemble`` on an
``EnsembleProblem``.  The port runs the shaped path only: the iterate is
``u0`` itself, one tensor of any shape (≥ 1-d), never flattened — except
on the simple tier, which runs on the flattened state as the JAX package
does (so a 0-d ``u0`` is accepted there); an empty ``u0`` returns
``Success`` at once, as in the JAX package.  The engine runs under
``torch.no_grad()`` on the device that ``u0`` is on.  When the algorithm takes the colored sparse-AD path, the
host-side plan (pattern, coloring, DIA tier) is built once before the loop
and cached.  Options whose machinery is not ported raise
``NotImplementedError`` naming the ROADMAP item that brings it.

``NonlinearSolution.counters``: ``jvp`` (products with the Jacobian in the
linear solves), ``krylov_iters`` and ``host_syncs``; a polyalgorithm's
also ``rungs`` — (index, retcode, nsteps) of each rung it ran — and
``winner``, the index of the rung that succeeded (-1: none).
"""

from __future__ import annotations

import dataclasses
import difflib
import weakref

import torch

from .. import _backend
from ..utils.norms import get_tolerance
from .descent import DescentCtx
from ..ops.sparse_jac import plan_sparse_jacobian
from .jacobian import JacobianSpec, wants_sparse
from .problems import (IntervalNonlinearProblem,
                       NonlinearLeastSquaresProblem, NonlinearProblem)
from .returncode import ReturnCode
from .solution import NLStats, NonlinearSolution
from .termination import default_termination_mode

_ALLOWED_KWARGS = frozenset({
    "abstol", "reltol", "maxiters", "maxtime", "termination_condition",
    "alias_u0",
    "precondition", "postcondition",
    "show_trace", "store_trace", "trace_level", "verbose", "time_phases",
    "trajectories", "mesh", "batch_axis",
})


def check_kwargs(kwargs) -> None:
    """Reject unknown solve kwargs (reference checkkwargs,
    solve.jl:174-179)."""
    unknown = sorted(set(kwargs) - _ALLOWED_KWARGS)
    if unknown:
        hints = []
        for k in unknown:
            close = difflib.get_close_matches(k, _ALLOWED_KWARGS, n=1)
            hints.append(f"{k!r}" + (f" (did you mean {close[0]!r}?)"
                                     if close else ""))
        raise TypeError(
            f"unrecognized solve keyword argument(s): {', '.join(hints)}. "
            f"Allowed: {sorted(_ALLOWED_KWARGS)}")


def _default_algorithm(prob):
    """``FastShortcutNLLSPolyalg`` for least squares, else
    ``FastShortcutNonlinearPolyalg`` (its complex ladder for a complex
    ``u0``); no ``u0_len``, so the ladder starts at Broyden at every
    size, as in the JAX package."""
    from ..solvers.polyalg import (FastShortcutNLLSPolyalg,
                                   FastShortcutNonlinearPolyalg)
    if isinstance(prob, NonlinearLeastSquaresProblem):
        return FastShortcutNLLSPolyalg()
    is_complex = isinstance(prob.u0, torch.Tensor) and prob.u0.is_complex()
    return FastShortcutNonlinearPolyalg(complex_eltype=is_complex)


def solve(prob, alg=None, **kwargs) -> NonlinearSolution:
    """Solve a nonlinear problem; with no ``alg``, the default
    polyalgorithm (``_default_algorithm``).

    kwargs: abstol, reltol, maxiters, termination_condition — merged over
    problem-level kwargs (call-site kwargs win)."""
    from .ensemble import EnsembleProblem, solve_ensemble_problem
    if isinstance(prob, EnsembleProblem):
        return solve_ensemble_problem(prob, alg, **kwargs)
    if type(prob) not in (NonlinearProblem, NonlinearLeastSquaresProblem,
                          IntervalNonlinearProblem):
        raise NotImplementedError(
            f"{type(prob).__name__} is not ported: the port solves "
            f"NonlinearProblem, NonlinearLeastSquaresProblem and "
            f"IntervalNonlinearProblem (the other problem types are "
            f"ROADMAP A.30)")
    merged = {**prob.kwargs, **kwargs}
    check_kwargs(merged)
    ens_only = sorted(k for k in ("trajectories", "mesh", "batch_axis")
                      if k in merged)
    if ens_only:
        raise TypeError(
            f"keyword argument(s) {ens_only} apply to ensemble solves only; "
            f"wrap the problem in an EnsembleProblem to use them")
    if isinstance(prob, IntervalNonlinearProblem):
        from ..solvers.bracketing import solve_bracketing
        return solve_bracketing(prob, alg, **merged)
    if alg is None:
        alg = _default_algorithm(prob)
    if merged.pop("maxtime", None) is not None:
        raise NotImplementedError("maxtime is ROADMAP A.18")
    return solve_nonlinear(prob, alg, **merged)


def _refuse_unported(**opts) -> None:
    for name, value in opts.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"solve option {name!r} is ROADMAP A.18")


# NonlinearFunction -> {(shape, dtype): ColoredJacobian}; a plan (and the
# device tables it holds) goes when its function does.
_SPARSE_PLANS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _maybe_sparse_plan(f, alg, spec, ctx, u0):
    """The host-side sparse Jacobian plan (pattern, coloring), built once
    before the loop when ``alg`` takes the colored sparse-AD path, and
    cached per (function, shape, dtype) so repeated solves reuse it."""
    if not wants_sparse(alg, spec):
        return None
    plans = _SPARSE_PLANS.setdefault(f, {})
    key = (tuple(u0.shape), u0.dtype)
    if key not in plans:
        plans[key] = plan_sparse_jacobian(
            ctx.f_flat, ctx.n_in, ctx.n_out, sparsity=spec.sparsity,
            colorvec=spec.colorvec)
    return plans[key]


def _null_solution(prob, abstol) -> NonlinearSolution:
    """The empty-state solution (the JAX package's _build_null_solution),
    returned before a sparse plan is built: rootfinding succeeds at once;
    least squares evaluates the residual at the empty point and succeeds
    when it is empty or ‖resid‖ < abstol (1e-6 by default)."""
    u0 = prob.u0
    retcode = ReturnCode.Success
    resid = u0
    syncs = 0
    if prob.is_least_squares:
        with torch.no_grad():
            resid = prob.f.f(u0, prob.p)
        tol = 1e-6 if abstol is None else float(abstol)
        if resid.numel():
            syncs = 1
            if not bool(_backend.fetch(
                    torch.linalg.vector_norm(resid) < tol)[0]):
                retcode = ReturnCode.Failure
    return NonlinearSolution(
        u=u0, resid=resid, retcode=retcode, stats=NLStats(),
        counters={"jvp": 0, "krylov_iters": 0, "host_syncs": syncs})


def solve_nonlinear(prob, alg, *, abstol=None, reltol=None, maxiters=1000,
                    termination_condition=None, precondition=None,
                    postcondition=None, show_trace=False, store_trace=False,
                    trace_level=None, verbose=None, time_phases=False,
                    alias_u0=False, **extra) -> NonlinearSolution:
    if extra:
        check_kwargs(extra)
        raise TypeError(
            f"keyword argument(s) {sorted(extra)} are handled by the "
            f"solve() front door, not solve_nonlinear(); call solve()")
    _refuse_unported(show_trace=show_trace, store_trace=store_trace,
                     trace_level=trace_level, verbose=verbose,
                     time_phases=time_phases, precondition=precondition,
                     postcondition=postcondition)
    if prob.lb is not None or prob.ub is not None:
        raise NotImplementedError("bounds (lb/ub) are ROADMAP A.18")
    u0, p = prob.u0, prob.p
    from ..solvers.simple import is_simple_alg
    simple = is_simple_alg(alg)
    if not isinstance(u0, torch.Tensor) or (u0.dim() == 0 and not simple):
        raise NotImplementedError(
            "u0 must be one tensor of ≥ 1 dimension (a 0-d tensor on the "
            "simple tier): pytree and scalar states (the flat path) are "
            "ROADMAP A.33")
    for name, t in (("u0", u0), ("p", p)):
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise NotImplementedError(
                f"{name} requires grad: differentiating through the solve "
                f"(the implicit-function rule) is ROADMAP A.28")
    if u0.numel() == 0:
        return _null_solution(prob, abstol)
    # alias_u0 has no effect: the engine never writes into u0.

    npdt = _backend.np_dtype(u0.dtype)
    abstol_v = npdt(get_tolerance(abstol, npdt))
    reltol_v = npdt(get_tolerance(reltol, npdt))
    is_lsq = prob.is_least_squares
    if termination_condition is None:
        termination_condition = default_termination_mode(
            is_lsq, getattr(alg, "default_termination_callee", "regular"))

    f = prob.f

    def f_flat(u):
        return f.f(u, p)

    with torch.no_grad():
        fu0 = f_flat(u0)
        if not isinstance(fu0, torch.Tensor):
            raise NotImplementedError(
                "the residual must return one tensor; pytree residuals are "
                "ROADMAP A.33")
        ctx = DescentCtx(f_flat=f_flat, n_in=u0.numel(), n_out=fu0.numel(),
                         is_least_squares=is_lsq, out_shape=tuple(fu0.shape))
        sparsity = (f.sparsity if f.sparsity is not None
                    else f.jac_prototype)
        spec = JacobianSpec(
            analytic=(None if f.jac is None else (
                lambda u: f.jac(u, p).reshape(ctx.n_out, ctx.n_in))),
            analytic_jvp=(None if f.jvp is None
                          else (lambda v, u: f.jvp(v, u, p))),
            analytic_vjp=(None if f.vjp is None
                          else (lambda v, u: f.vjp(v, u, p))),
            sparsity=sparsity, colorvec=f.colorvec)
        spec = dataclasses.replace(
            spec, sparse_plan=_maybe_sparse_plan(f, alg, spec, ctx, u0))
        from ..solvers.dispatch import run_algorithm
        syncs0 = _backend.HOST_SYNCS["n"]
        carry = run_algorithm(alg, ctx, termination_condition, spec, u0,
                              abstol_v, reltol_v, int(maxiters))
        counters = {"jvp": carry.njvp, "krylov_iters": carry.krylov_iters,
                    "host_syncs": _backend.HOST_SYNCS["n"] - syncs0}
        if hasattr(carry, "winner"):
            counters["rungs"] = list(carry.rungs)
            counters["winner"] = carry.winner
    return NonlinearSolution(u=carry.u, resid=carry.fu,
                             retcode=ReturnCode(carry.retcode),
                             stats=carry.stats,
                             counters=counters)

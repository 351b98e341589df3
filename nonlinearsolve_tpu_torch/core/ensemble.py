"""Ensemble solves (the port of ``core/ensemble.py``): ``EnsembleProblem``,
``solve_ensemble_problem`` and ``solve_ensemble``.

The JAX package ``vmap``s the whole solver over a leading trajectory axis
of ``u0`` and / or ``p``.  Here:

- the simple tier and the bracketing tier run the batch as one lockstep
  loop on the device (``solvers/simple.py``, ``solvers/bracketing.py``);
- every other algorithm (the first-order and quasi-Newton engines, the
  polyalgorithms) solves trajectory by trajectory and stacks the fields on
  a leading axis.  A vmapped ``while_loop`` freezes a finished lane, so
  each trajectory's result there is its lone solve's, which is what this
  gives.  Batched engines of that kind are ROADMAP A.29.

Either way the solution's fields carry the batch axis: ``u`` (B, ...),
``retcode`` a (B,) int tensor, each ``NLStats`` field a (B,) tensor.
Trajectories that do not share the base problem's function and shapes
solve one by one and come back as a list.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .. import _backend
from ..utils.norms import get_tolerance
from .problems import IntervalNonlinearProblem
from .solution import NLStats, NonlinearSolution
from .termination import default_termination_mode


@dataclasses.dataclass(frozen=True)
class EnsembleProblem:
    """A family of problems made from a base problem.  ``prob_func(prob,
    i) -> prob_i`` builds trajectory ``i``'s problem (typically
    ``prob.remake(u0=...)``); the identity when omitted.  Solve with
    ``solve(eprob, alg, trajectories=N)``."""

    prob: Any
    prob_func: Optional[Callable] = None


def _shape(x):
    if x is None:
        return None
    if isinstance(x, (tuple, list)):
        return tuple(_shape(v) for v in x)
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    return ()


def _stack(values, like):
    """Stack per-trajectory leaves on a new first axis; Python numbers go
    on ``like``'s device in float64 (as a Python float is under x64)."""
    first = values[0]
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([v[i] for v in values], like)
                           for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(values)
    return torch.tensor(values, dtype=torch.float64, device=like.device)


def _row(x, i):
    if isinstance(x, (tuple, list)):
        return type(x)(_row(v, i) for v in x)
    return x[i]


def _first_device(*trees):
    for t in trees:
        if isinstance(t, torch.Tensor):
            return t.device
        if isinstance(t, (tuple, list)):
            d = _first_device(*t)
            if d is not None:
                return d
    return None


def solve_ensemble_problem(eprob: EnsembleProblem, alg=None, *,
                           trajectories: int, mesh=None,
                           batch_axis: str = "batch", **kwargs):
    """Build the trajectories' problems on the host; one batched solve when
    they share the base problem's function and shapes, else a list of
    solves."""
    base = eprob.prob
    pf = eprob.prob_func or (lambda prob, i: prob)
    probs = [pf(base, i) for i in range(int(trajectories))]
    interval = isinstance(base, IntervalNonlinearProblem)
    state = (lambda q: q.tspan) if interval else (lambda q: q.u0)
    uniform = (all(q.f is base.f for q in probs)
               and all(_shape(state(q)) == _shape(state(base))
                       for q in probs)
               and all(_shape(q.p) == _shape(base.p) for q in probs))
    if not uniform:
        from .solve import solve
        return [solve(q, alg, **kwargs) for q in probs]
    like = torch.empty(0, device=_first_device(
        *[state(q) for q in probs], *[q.p for q in probs])
        or _backend.resolve_device(None))
    ps = None if base.p is None else _stack([q.p for q in probs], like)
    if interval:
        left = _stack([q.tspan[0] for q in probs], like)
        right = _stack([q.tspan[1] for q in probs], like)
        return solve_ensemble(base.remake(tspan=(left, right)), alg, ps=ps,
                              mesh=mesh, batch_axis=batch_axis, **kwargs)
    u0s = _stack([q.u0 for q in probs], like)
    return solve_ensemble(base, alg, u0s=u0s, ps=ps, mesh=mesh,
                          batch_axis=batch_axis, **kwargs)


def solve_ensemble(prob, alg=None, *, u0s=None, ps=None, mesh=None,
                   batch_axis: str = "batch", **kwargs) -> NonlinearSolution:
    """Solve one problem family over a batch of initial states ``u0s``
    (like ``prob.u0`` with a leading batch axis) and / or parameters
    ``ps`` (like ``prob.p``, leading batch axis).  For an
    ``IntervalNonlinearProblem``, ``ps`` is the batch (its ``tspan`` may
    be batched too).  Returns one ``NonlinearSolution`` whose fields carry
    the batch axis.  ``mesh`` (sharding the batch over devices) is ROADMAP
    A.29."""
    from ..solvers.simple import is_simple_alg
    from .solve import _default_algorithm, check_kwargs, solve_nonlinear

    if kwargs.pop("maxtime", None) is not None:
        raise NotImplementedError(
            "maxtime is not supported for ensemble solves: the budget is "
            "enforced by host-clock chunked advances, which cannot run "
            "inside vmap.  Batch with maxtime by looping solve(..., "
            "maxtime=...) per trajectory instead.")
    if mesh is not None:
        raise NotImplementedError(
            "solve_ensemble(mesh=...): sharding the batch over devices is "
            "ROADMAP A.29")
    if u0s is None and ps is None:
        raise ValueError("solve_ensemble needs u0s and/or ps batches")
    merged = {**prob.kwargs, **kwargs}
    check_kwargs(merged)
    if isinstance(prob, IntervalNonlinearProblem):
        from ..solvers.bracketing import solve_bracketing
        return solve_bracketing(prob if ps is None else prob.remake(p=ps),
                                alg, **merged)
    if alg is None:
        alg = _default_algorithm(prob)
    if is_simple_alg(alg) and not _lone_options(prob, merged):
        return _solve_simple_batch(prob, alg, u0s, ps, **merged)

    B = (u0s if u0s is not None else _first_leaf(ps)).shape[0]
    sols = [solve_nonlinear(
        prob.remake(u0=None if u0s is None else u0s[i],
                    p=None if ps is None else _row(ps, i)), alg, **merged)
        for i in range(B)]
    dev = sols[0].u.device
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)
    return NonlinearSolution(
        u=torch.stack([s.u for s in sols]),
        resid=torch.stack([s.resid for s in sols]),
        retcode=ints([int(s.retcode) for s in sols]),
        stats=NLStats(*[ints([getattr(s.stats, k) for s in sols])
                        for k in ("nf", "njacs", "nfactors", "nsolve",
                                  "nsteps")]),
        counters={"host_syncs": sum(s.counters["host_syncs"]
                                    for s in sols)})


def _lone_options(prob, merged) -> bool:
    """Options the lockstep batch does not take (bounds, conditioning,
    traces, messages, timers): with them, a simple batch is solved
    trajectory by trajectory, each lone solve giving the batch's row."""
    return (getattr(prob, "lb", None) is not None
            or getattr(prob, "ub", None) is not None
            or any(merged.get(k) for k in (
                "precondition", "postcondition", "show_trace",
                "store_trace", "trace_level", "verbose", "time_phases")))


def _first_leaf(tree):
    return tree[0] if isinstance(tree, (tuple, list)) else tree


def _solve_simple_batch(prob, alg, u0s, ps, *, abstol=None, reltol=None,
                        maxiters=1000, termination_condition=None,
                        alias_u0=False, **_off) -> NonlinearSolution:
    """The batch as one lockstep run of the simple tier (``_off``: options
    that are unset, see ``_lone_options``)."""
    from ..solvers.simple import BatchedResidual, run_simple_batched

    u0 = prob.u0
    if not isinstance(u0, torch.Tensor):
        raise NotImplementedError(
            "u0 must be one tensor: pytree states are ROADMAP A.33")
    shape = tuple(u0.shape)
    if u0s is not None:
        B = u0s.shape[0]
        X0 = u0s.reshape(B, -1)
    else:
        B = _first_leaf(ps).shape[0]
        X0 = u0.reshape(1, -1).expand(B, -1).clone()
    P, pdim = (prob.p, None) if ps is None else (ps, 0)
    f = prob.f

    def f1(v, p):
        return f.f(v.reshape(shape), p).reshape(-1)

    jac1 = None
    if f.jac is not None:
        def jac1(v, p):
            return f.jac(v.reshape(shape), p).reshape(-1, v.shape[0])

    with torch.no_grad():
        first = P if pdim is None else _row(P, slice(0, 1))
        fu_first = torch.func.vmap(lambda v, p: f.f(v.reshape(shape), p),
                                   in_dims=(0, pdim))(X0[:1], first)
        out_shape = tuple(fu_first.shape[1:])
        npdt = _backend.np_dtype(X0.dtype)
        is_lsq = prob.is_least_squares
        if termination_condition is None:
            termination_condition = default_termination_mode(is_lsq,
                                                             "simple")
        res = BatchedResidual(f1=f1, p=P, pdim=pdim,
                              n_out=fu_first[0].numel(), jac1=jac1,
                              is_least_squares=is_lsq)
        syncs0 = _backend.HOST_SYNCS["n"]
        final = run_simple_batched(
            alg, res, termination_condition, X0,
            npdt(get_tolerance(abstol, npdt)),
            npdt(get_tolerance(reltol, npdt)), int(maxiters))
    return NonlinearSolution(
        u=final.u.reshape((B,) + shape),
        resid=final.fu.reshape((B,) + out_shape), retcode=final.retcode,
        stats=final.stats,
        counters={"host_syncs": _backend.HOST_SYNCS["n"] - syncs0})

"""Ensemble solves (the port of ``core/ensemble.py``): ``EnsembleProblem``,
``solve_ensemble_problem`` and ``solve_ensemble``.

The JAX package ``vmap``s the whole solver over a leading trajectory axis
of ``u0`` and / or ``p``.  Here:

- the simple tier, the bracketing tier, the first-order engines on a
  dense Jacobian (NewtonRaphson with or without BackTracking, TrustRegion
  under the simple and Fan schemes, LevenbergMarquardt), Broyden,
  Klement and the ladders of them (the default one among them) run the
  batch as one lockstep loop on the device (``solvers/simple.py``,
  ``solvers/bracketing.py``, ``solvers/first_order_lockstep.py``);
- every other algorithm (Krylov or sparse linear solves, forcing,
  PseudoTransient, the other radius schemes and line searches, DFSane,
  Anderson, LimitedMemoryBroyden, the ladders that hold them) and every
  option the batch does not take (``_lone_options``) solve trajectory by
  trajectory and stack the fields on a leading axis.  A vmapped
  ``while_loop`` freezes a finished lane, so each trajectory's result
  there is its lone solve's, which is what this gives.

``sol.counters["ensemble_route"]`` says which ran: ``"lockstep"`` or
``"lone"``.  Each row of a lockstep batch equals its lone solve bit for
bit on the CPU.

With ``mesh=`` the batch's rows are split over a mesh axis: each rank
solves its rows as above, and the fields come back as DTensors.

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
from ..utils.pytree import (ravel_pytree, tree_flatten, tree_leaves,
                            tree_map)
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
    leaves, spec = tree_flatten(x)
    return spec, tuple(tuple(v.shape) if isinstance(v, torch.Tensor)
                       else () for v in leaves)


def _stack(values, like):
    """Stack per-trajectory trees leaf by leaf on a new first axis; Python
    numbers go on ``like``'s device in float64 (as a Python float is under
    x64)."""
    def stack(*leaves):
        if isinstance(leaves[0], torch.Tensor):
            return torch.stack(leaves)
        return torch.tensor(leaves, dtype=torch.float64, device=like.device)
    return tree_map(stack, *values)


def _row(x, i):
    """Row ``i`` of every leaf of a batched tree."""
    return tree_map(lambda v: v[i], x)


def _first_device(*trees):
    for t in trees:
        for leaf in tree_leaves(t):
            if isinstance(leaf, torch.Tensor):
                return leaf.device
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
    the batch axis.  ``mesh`` (a ``DeviceMesh``) shards the batch over its
    axis ``batch_axis``, whose size must divide the batch: each rank solves
    its rows, and the fields come back as DTensors sharded on the batch.
    Every rank of the mesh calls it with the same batches."""
    from ..solvers.simple import is_simple_alg
    from .solve import _default_algorithm, check_kwargs, solve_nonlinear

    if kwargs.pop("maxtime", None) is not None:
        raise NotImplementedError(
            "maxtime is not supported for ensemble solves: the budget is "
            "enforced by host-clock chunked advances, which cannot run "
            "inside vmap.  Batch with maxtime by looping solve(..., "
            "maxtime=...) per trajectory instead.")
    if u0s is None and ps is None:
        raise ValueError("solve_ensemble needs u0s and/or ps batches")
    if mesh is not None:
        return _solve_sharded(prob, alg, u0s, ps, mesh, batch_axis, kwargs)
    merged = {**prob.kwargs, **kwargs}
    check_kwargs(merged)
    if isinstance(prob, IntervalNonlinearProblem):
        from ..solvers.bracketing import solve_bracketing
        return solve_bracketing(prob if ps is None else prob.remake(p=ps),
                                alg, **merged)
    if alg is None:
        alg = _default_algorithm(prob)
    if not _lone_options(prob, merged) and (
            is_simple_alg(alg) or _lockstep_batch(prob, alg, u0s, ps)):
        sol = _solve_lockstep(prob, alg, u0s, ps, **merged)
        if sol is not None:
            return sol

    B = _first_leaf(u0s if u0s is not None else ps).shape[0]
    sols = [solve_nonlinear(
        prob.remake(u0=None if u0s is None else _row(u0s, i),
                    p=None if ps is None else _row(ps, i)), alg, **merged)
        for i in range(B)]
    dev = _first_leaf(sols[0].u).device
    ints = lambda xs: torch.tensor(xs, dtype=torch.int32, device=dev)
    return NonlinearSolution(
        u=tree_map(lambda *r: torch.stack(r), *[s.u for s in sols]),
        resid=tree_map(lambda *r: torch.stack(r),
                       *[s.resid for s in sols]),
        retcode=ints([int(s.retcode) for s in sols]),
        stats=NLStats(*[ints([getattr(s.stats, k) for s in sols])
                        for k in ("nf", "njacs", "nfactors", "nsolve",
                                  "nsteps")]),
        counters={"host_syncs": sum(s.counters["host_syncs"]
                                    for s in sols),
                  "ensemble_route": "lone"})


def _solve_sharded(prob, alg, u0s, ps, mesh, batch_axis, kwargs):
    """``solve_ensemble`` with the batch's rows split over
    ``mesh[batch_axis]``: this rank's rows (of a plain batch, the same on
    every rank, or of a DTensor batch) through the unsharded ensemble,
    the fields wrapped as DTensors sharded on the batch (and replicated
    over the mesh's other axes)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard

    group = mesh.get_group(batch_axis)
    S, me = dist.get_world_size(group), dist.get_rank(group)
    B = _first_leaf(u0s if u0s is not None else ps).shape[0]
    if B % S:
        raise ValueError(f"a batch of {B} does not split over the "
                         f"{S} devices of mesh axis {batch_axis!r}")
    rows = slice(me * (B // S), (me + 1) * (B // S))
    placements = [Shard(0) if name == batch_axis else Replicate()
                  for name in mesh.mesh_dim_names]

    def local(x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        if isinstance(x, torch.Tensor) and x.dim() >= 1 and \
                x.shape[0] == B:
            return x[rows]
        return x

    if isinstance(prob, IntervalNonlinearProblem):
        prob = prob.remake(tspan=tree_map(local, prob.tspan))
    sol = solve_ensemble(
        prob, alg, u0s=None if u0s is None else tree_map(local, u0s),
        ps=None if ps is None else tree_map(local, ps), **kwargs)

    def whole(x):
        full = torch.empty((B,) + tuple(x.shape[1:]), device="meta")
        return DTensor.from_local(x, mesh, placements, run_check=False,
                                  shape=full.shape, stride=full.stride())

    return dataclasses.replace(
        sol, u=tree_map(whole, sol.u), resid=tree_map(whole, sol.resid),
        retcode=whole(sol.retcode),
        stats=NLStats(*[whole(getattr(sol.stats, k)) for k in (
            "nf", "njacs", "nfactors", "nsolve", "nsteps")]))


def _lone_options(prob, merged) -> bool:
    """Options the lockstep batch does not take (bounds, conditioning,
    traces, messages, timers): with them, a batch is solved trajectory by
    trajectory, each lone solve giving the batch's row."""
    return (getattr(prob, "lb", None) is not None
            or getattr(prob, "ub", None) is not None
            or any(merged.get(k) for k in (
                "precondition", "postcondition", "show_trace",
                "store_trace", "trace_level", "verbose", "time_phases")))


def _batched_of(f, u0, jacobian=False):
    """The residual (``jacobian``: the analytic Jacobian) of a whole batch
    of flat rows, when ``f`` carries one (``f.batched``: a loaded batched
    program, ``utils/aot.py``) and the state is one tensor; else None."""
    batched = getattr(f, "batched", None)
    if batched is None or not isinstance(u0, torch.Tensor):
        return None
    shape = tuple(u0.shape)

    def rows(X, p):
        B = X.shape[0]
        out = batched(X.reshape((B,) + shape), p)
        return out.reshape(B, -1, X.shape[1]) if jacobian else out.reshape(
            B, -1)
    return rows


def _first_leaf(tree):
    return tree_leaves(tree)[0]


def _lockstep_batch(prob, alg, u0s, ps) -> bool:
    """True when ``alg`` runs as a lockstep batch of the first-order
    engines (``solvers/first_order_lockstep.py``): a real state, a dense
    Jacobian (no sparsity pattern), and no parameter that carries a
    gradient (the implicit-function rule is the lone solve's).  A
    non-square residual is found later (``_solve_lockstep``)."""
    from ..solvers.first_order_lockstep import lockstep_supported
    f = prob.f
    if (not lockstep_supported(alg) or f.sparsity is not None
            or f.jac_prototype is not None):
        return False
    leaves = [v for t in (prob.u0, prob.p, u0s, ps)
              for v in tree_leaves(t) if isinstance(v, torch.Tensor)]
    return all(not v.is_complex() and not v.requires_grad for v in leaves)


def _solve_lockstep(prob, alg, u0s, ps, *, abstol=None, reltol=None,
                    maxiters=1000, termination_condition=None,
                    alias_u0=False, **_off) -> Optional[NonlinearSolution]:
    """The batch as one lockstep run: the simple tier's engines, or the
    first-order and quasi-Newton engines and their ladders on a square
    residual (None for any other residual: the caller solves it
    trajectory by trajectory).
    ``_off``: options that are unset, see ``_lone_options``."""
    from ..solvers.first_order_lockstep import run_lockstep
    from ..solvers.simple import (BatchedResidual, is_simple_alg,
                                  run_simple_batched)

    from .solve import state_device
    dev = state_device(prob.u0, prob.p)
    u0_flat, unravel = ravel_pytree(prob.u0, device=dev)
    if u0s is not None:
        # each trajectory's state raveled as u0 is (JAX's leaf order)
        X0 = torch.func.vmap(lambda t: ravel_pytree(t, device=dev)[0])(u0s)
        B = X0.shape[0]
    else:
        B = _first_leaf(ps).shape[0]
        X0 = u0_flat.reshape(1, -1).expand(B, -1).clone()
    P, pdim = (prob.p, None) if ps is None else (ps, 0)
    f = prob.f
    out = {}

    def f1(v, p):
        flat, out["unravel"] = ravel_pytree(f.f(unravel(v), p), device=dev)
        return flat

    jac1 = None
    if f.jac is not None:
        def jac1(v, p):
            return f.jac(unravel(v), p).reshape(-1, v.shape[0])

    simple = is_simple_alg(alg)
    with torch.no_grad():
        first = P if pdim is None else _row(P, slice(0, 1))
        fu_first = torch.func.vmap(f1, in_dims=(0, pdim))(X0[:1], first)
        if not simple and fu_first[0].numel() != X0.shape[1]:
            return None
        npdt = _backend.np_dtype(X0.dtype)
        is_lsq = prob.is_least_squares
        if termination_condition is None:
            termination_condition = default_termination_mode(
                is_lsq, "simple" if simple else "regular")
        res = BatchedResidual(f1=f1, p=P, pdim=pdim,
                              n_out=fu_first[0].numel(), jac1=jac1,
                              is_least_squares=is_lsq,
                              batched=_batched_of(f.f, prob.u0),
                              jac_batched=(None if jac1 is None else
                                           _batched_of(f.jac, prob.u0,
                                                       jacobian=True)))
        syncs0 = _backend.HOST_SYNCS["n"]
        run = run_simple_batched if simple else run_lockstep
        final = run(alg, res, termination_condition, X0,
                    npdt(get_tolerance(abstol, npdt)),
                    npdt(get_tolerance(reltol, npdt)), int(maxiters))
    return NonlinearSolution(
        u=torch.func.vmap(unravel)(final.u),
        resid=torch.func.vmap(out["unravel"])(final.fu),
        retcode=final.retcode,
        stats=final.stats,
        counters={"host_syncs": _backend.HOST_SYNCS["n"] - syncs0,
                  "ensemble_route": "lockstep"})

"""Top-level ``solve`` (the port of ``core/solve.py``).

``solve`` checks the keyword arguments, merges call-site over problem
kwargs, runs a problem's initialization hook and then
``solve_nonlinear`` on a ``NonlinearProblem`` or a
``NonlinearLeastSquaresProblem`` (through the iterator, ``core/cache.py``,
when given ``maxtime``; a ``SteadyStateProblem`` is converted to one
first, ``SSRootfind(alg)`` unwraps to ``alg``),
``solvers.bracketing.solve_bracketing`` on an ``IntervalNonlinearProblem``,
``solvers.homotopy.solve_homotopy`` on a ``HomotopyProblem``,
``solvers.scc.solve_scc`` on an ``SCCNonlinearProblem``,
``solvers.wrappers.solve_wrapper`` with a SciPy bridge,
``solvers.homotopy_continuation`` with ``HomotopyContinuationJL`` /
``TaylorHomotopyContinuationJL`` and
``core.ensemble`` on an ``EnsembleProblem``.  As in the JAX package, one
tensor ``u0`` of ≥ 1 dimension with a one-tensor residual, no bounds and
a first-order or spectral engine runs shaped: the iterate is ``u0``
itself, never flattened (``shaped_supported``).  Everything else runs on
the flat state of ``utils/pytree.py``'s ``ravel_pytree`` (JAX's leaf
order and dtype promotion): pytree states and residuals, 0-d states,
bounded states and the matrix-building engines; the solution gives ``u``
and ``resid`` back in their trees.  An empty ``u0`` returns ``Success``
at once, as in the JAX package.  Bounds (``lb``/``ub``) solve in the
unbounded variable of ``core/bounds.py``.

The engine runs under ``torch.no_grad()`` on the device that ``u0`` is
on.  When ``p`` carries a gradient (a leaf that requires grad, or a
forward-mode tangent), the root is joined to it by the implicit-function
rule (``core/sensitivity.py``) on the bounded and preconditioned
residual, as in the JAX package.  When the algorithm takes the colored
sparse-AD path, the host-side plan (pattern, coloring, DIA tier) is built
once before the loop and cached.

``NonlinearSolution.counters``: ``jvp`` (products with the Jacobian in the
linear solves), ``krylov_iters`` and ``host_syncs``; a polyalgorithm's
also ``rungs`` — (index, retcode, nsteps) of each rung it ran — and
``winner``, the index of the rung that succeeded (-1: none).
"""

from __future__ import annotations

import contextlib
import dataclasses
import difflib
import weakref
from typing import Any

import numpy as np
import torch

from .. import _backend
from ..utils.norms import get_tolerance
from ..utils.pytree import ravel_pytree, tree_leaves
from .descent import DescentCtx
from ..ops.sparse_jac import plan_sparse_jacobian
from .jacobian import JacobianSpec, wants_sparse
from .problems import (HomotopyProblem, IntervalNonlinearProblem,
                       NonlinearFunction, NonlinearLeastSquaresProblem,
                       NonlinearProblem, SCCNonlinearProblem,
                       SteadyStateProblem)
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
    if isinstance(prob, SteadyStateProblem):
        prob = prob.to_nonlinear()
    merged = {**prob.kwargs, **kwargs}
    check_kwargs(merged)
    ens_only = sorted(k for k in ("trajectories", "mesh", "batch_axis")
                      if k in merged)
    if ens_only:
        raise TypeError(
            f"keyword argument(s) {ens_only} apply to ensemble solves only; "
            f"wrap the problem in an EnsembleProblem to use them")
    from ..solvers.steady_state import DynamicSS, SSRootfind
    if isinstance(alg, SSRootfind):
        alg = alg.alg            # rootfind on the converted problem
    elif isinstance(alg, DynamicSS):
        # the derivative test's defaults, not the rootfinder's eps^(4/5)
        if merged.get("abstol") is None:
            merged["abstol"] = 1e-8
        if merged.get("reltol") is None:
            merged["reltol"] = 1e-6
    # the initialization hook: its sub-problem first; abort on failure
    init_data = getattr(getattr(prob, "f", None), "initialization_data",
                        None)
    if init_data is not None:
        from .initialization import (initial_failure_solution,
                                     run_initialization)
        prob, init_sol, ok = run_initialization(prob, init_data)
        if not ok:
            return initial_failure_solution(prob, init_sol)
    # the empty state solves at once, before any plan is built
    if isinstance(prob, NonlinearProblem) and (
            prob.u0 is None or (isinstance(prob.u0, torch.Tensor)
                                and prob.u0.numel() == 0)):
        return _null_solution(prob, merged.get("abstol"))
    if isinstance(prob, IntervalNonlinearProblem):
        from ..solvers.wrappers import SciPyRootScalar, solve_wrapper
        if isinstance(alg, SciPyRootScalar):
            return solve_wrapper(prob, alg, **merged)
        from ..solvers.bracketing import solve_bracketing
        return solve_bracketing(prob, alg, **merged)
    if isinstance(prob, HomotopyProblem):
        from ..solvers.homotopy import solve_homotopy
        return solve_homotopy(prob, alg, **merged)
    if isinstance(prob, SCCNonlinearProblem):
        # maxtime is a per-block budget there
        from ..solvers.scc import solve_scc
        return solve_scc(prob, alg, **merged)
    if not isinstance(prob, NonlinearProblem):
        raise TypeError(f"cannot solve a {type(prob).__name__}")
    from ..solvers.wrappers import is_wrapper_alg, solve_wrapper
    if is_wrapper_alg(alg):
        return solve_wrapper(prob, alg, **merged)
    from ..solvers.homotopy_continuation import (
        HomotopyContinuationJL, TaylorHomotopyContinuationJL,
        solve_homotopy_continuation)
    if isinstance(alg, (HomotopyContinuationJL, TaylorHomotopyContinuationJL)):
        return solve_homotopy_continuation(prob, alg, **merged)
    if alg is None:
        alg = _default_algorithm(prob)
    # a time budget runs through the iterator, checked between chunks of
    # steps on the host clock
    maxtime = merged.pop("maxtime", None)
    if maxtime is not None:
        from .cache import init as cache_init
        cache = cache_init(
            prob, alg, **{k: v for k, v in merged.items()
                          if k in ("abstol", "reltol", "maxiters",
                                   "termination_condition")})
        return cache.solve(maxtime=float(maxtime))
    return solve_nonlinear(prob, alg, **merged)


# NonlinearFunction -> {(shape, dtype): ColoredJacobian}; a plan (and the
# device tables it holds) goes when its function does.
_SPARSE_PLANS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _maybe_sparse_plan(f, alg, spec, f_flat, n_in, n_out, u0):
    """The host-side sparse Jacobian plan (pattern, coloring) of the
    residual ``f_flat``, built once before the loop when ``alg`` takes the
    colored sparse-AD path, and cached per (function, shape, dtype) so
    repeated solves reuse it (a flat path's function by the user's
    function and the flat shape)."""
    if not wants_sparse(alg, spec):
        return None
    plans = _SPARSE_PLANS.setdefault(getattr(f, "owner", None) or f, {})
    key = (tuple(u0.shape), u0.dtype)
    if key not in plans:
        plans[key] = plan_sparse_jacobian(
            f_flat, n_in, n_out, sparsity=spec.sparsity,
            colorvec=spec.colorvec, dtype=u0.dtype, device=u0.device)
    return plans[key]


def _null_solution(prob, abstol) -> NonlinearSolution:
    """The empty-state solution (the JAX package's _build_null_solution),
    returned before a sparse plan is built: rootfinding succeeds at once;
    least squares evaluates the residual at the empty point and succeeds
    when it is empty or ‖resid‖ < abstol (1e-6 by default).  A ``u0`` of
    None is an empty float64 state on the device of ``p`` (the card when
    ``p`` is not a tensor)."""
    u0 = prob.u0
    if u0 is None:
        p = prob.p
        dev = (p.device if isinstance(p, torch.Tensor)
               else _backend.resolve_device(None))
        u0 = torch.zeros((0,), dtype=torch.float64, device=dev)
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


def _postcondition_of(postcondition, p, bounds):
    """The corrector on the iterate: ``H(u, u_prev, p)`` itself, or, with
    bounds and a corrector written in the original space (the default),
    mapped back, corrected, clamped into the interior and mapped forward
    again."""
    if postcondition is None:
        return None
    corrector = getattr(postcondition, "corrector", postcondition)
    space = getattr(postcondition, "space", "original")
    if bounds is None or space != "original":
        return lambda u, u_prev: corrector(u, u_prev, p)
    from .bounds import clamp_to_bounds, from_unbounded, to_unbounded
    lbf, ubf = bounds

    def post(t, t_prev):
        u = corrector(from_unbounded(t, lbf, ubf),
                      from_unbounded(t_prev, lbf, ubf), p)
        return to_unbounded(clamp_to_bounds(u, lbf, ubf), lbf, ubf)
    return post


def _emit_solve_messages(verbosity, alias_u0, postcondition, has_bounds):
    if verbosity is None:
        return
    if alias_u0:
        verbosity.emit(
            "alias_u0_immutable",
            "alias_u0=True has no effect: the solver never writes into u0, "
            "it always works on fresh buffers")
    verbosity.emit(
        "sensitivity_vjp_choice",
        "reverse-mode sensitivities solve the transposed implicit-function "
        "system at the root (core/sensitivity.py) — no adjoint solver "
        "selection needed")
    if postcondition is not None and not has_bounds and getattr(
            postcondition, "space", "original") == "transformed":
        verbosity.emit(
            "unsupported_postcondition",
            "postcondition declared in the transformed space but the "
            "problem has no bounds — the corrector runs in the original "
            "coordinates (conditioning.jl:46-66)")


def shaped_supported(alg) -> bool:
    """Engines that run on the shaped state (no flattening): the
    first-order and spectral engines, and polyalgorithms of them only."""
    from ..solvers.first_order import GeneralizedFirstOrderAlgorithm
    from ..solvers.polyalg import NonlinearSolvePolyAlgorithm
    from ..solvers.spectral import GeneralizedDFSane
    if isinstance(alg, NonlinearSolvePolyAlgorithm):
        return all(shaped_supported(a) for a in alg.algs)
    return isinstance(alg, (GeneralizedFirstOrderAlgorithm,
                            GeneralizedDFSane))


def state_device(u0, p=None) -> torch.device:
    """The device of the first tensor leaf of ``u0``, else of ``p``, else
    the card."""
    for tree in (u0, p):
        for leaf in tree_leaves(tree):
            if isinstance(leaf, torch.Tensor):
                return leaf.device
    return _backend.resolve_device(None)


def state_tensor(u0, p=None, device=None) -> torch.Tensor:
    """A single-leaf ``u0`` as one tensor on ``device`` (by default
    ``state_device(u0, p)``): a Python number or list in the dtype JAX
    gives it under x64 (a float is f64, a complex complex128), a numpy
    value in its own dtype."""
    t = u0 if isinstance(u0, torch.Tensor) else torch.as_tensor(
        np.asarray(u0))
    return t.to(state_device(u0, p) if device is None else device)


@dataclasses.dataclass(frozen=True, eq=False)
class FlatFunction(NonlinearFunction):
    """A ``NonlinearFunction`` on the flat state; ``owner`` is the user's
    function (the key of its sparse plan)."""

    owner: Any = None


class FlatMap:
    """The flat path's maps: ``unravel_u`` to ``u0``'s tree, and
    ``unravel_fu`` to the residual's (known once ``f`` has run)."""

    def __init__(self, u0, device):
        self.u0_flat, self.unravel_u = ravel_pytree(u0, device=device)
        self.device = device
        self.unravel_fu = None

    def ravel(self, tree):
        return ravel_pytree(tree, device=self.device)

    def ravel_out(self, tree):
        """The residual's tree raveled; below double precision a copy in
        its own dtype, since under ``torch.func.jvp`` a 0-d f32 tensor
        combined with a Python float carries an f64 tangent (ROADMAP C)."""
        flat, self.unravel_fu = self.ravel(tree)
        if flat.dtype not in (torch.float64, torch.complex128):
            flat = flat.to(flat.dtype, copy=True)
        return flat

    def function(self, f: NonlinearFunction) -> FlatFunction:
        """``f`` and its analytic derivatives on flat vectors."""
        un, n_in = self.unravel_u, self.u0_flat.numel()
        rav = lambda t: self.ravel(t)[0]
        return FlatFunction(
            f=lambda u, p: self.ravel_out(f.f(un(u), p)),
            jac=(None if f.jac is None else
                 (lambda u, p: f.jac(un(u), p).reshape(-1, n_in))),
            jvp=(None if f.jvp is None else
                 (lambda v, u, p: rav(f.jvp(un(v), un(u), p)))),
            vjp=(None if f.vjp is None else
                 (lambda v, u, p: rav(f.vjp(self.unravel_fu(v), un(u), p)))),
            jac_prototype=f.jac_prototype, sparsity=f.sparsity,
            colorvec=f.colorvec, owner=getattr(f, "owner", None) or f)

    def bound(self, b):
        """A bound given as a tree like ``u0``'s, flattened; None,
        numbers and sequences as they are."""
        if isinstance(b, (dict, tuple)) or (
                isinstance(b, list) and any(isinstance(x, torch.Tensor)
                                            for x in b)):
            return self.ravel(b)[0]
        if isinstance(b, torch.Tensor):
            return b.reshape(-1)
        return b

    def precondition(self, precondition):
        if precondition is None:
            return None
        un = self.unravel_u
        return lambda fu, u, p: self.ravel(precondition(
            self.unravel_fu(fu), un(u), p))[0]

    def postcondition(self, postcondition):
        if postcondition is None:
            return None
        un = self.unravel_u
        corrector = getattr(postcondition, "corrector", postcondition)
        flat = lambda u, u_prev, p: self.ravel(corrector(un(u), un(u_prev),
                                                         p))[0]
        if hasattr(postcondition, "corrector"):
            return dataclasses.replace(postcondition, corrector=flat)
        return flat


def flat_problem(prob, fmap: FlatMap):
    """``prob`` on the flat state (its function, ``u0`` and bounds)."""
    return type(prob)(fmap.function(prob.f), fmap.u0_flat, prob.p,
                      lb=fmap.bound(prob.lb), ub=fmap.bound(prob.ub),
                      **prob.kwargs)


def takes_flat_path(prob, alg) -> bool:
    """True unless the shaped rule holds for the state, the bounds and the
    engine (the residual's tree is checked once it has run)."""
    if isinstance(prob.f, FlatFunction):
        return False
    return not (isinstance(prob.u0, torch.Tensor) and prob.u0.dim() >= 1
                and prob.lb is None and prob.ub is None
                and shaped_supported(alg))


@dataclasses.dataclass
class Prepared:
    """A problem set up for an engine: the context and Jacobian spec on
    the iterate (the unbounded variable when there are bounds), the
    starting iterate ``x0``, the tolerances in the working dtype, the
    termination mode, the residual of the iterate and ``p``, ``bounds``
    (the normalized (lb, ub) or None) and the indices of ``p``'s leaves
    that carry a gradient."""

    ctx: DescentCtx
    spec: JacobianSpec
    x0: torch.Tensor
    abstol: object
    reltol: object
    term_cfg: object
    residual: object
    bounds: object
    grad_index: list
    flat: FlatMap = None         # the flat path's maps (None: shaped)

    def to_tree(self, u):
        """An iterate in ``u0``'s tree."""
        return u if self.flat is None else self.flat.unravel_u(u)

    def resid_tree(self, fu):
        return fu if self.flat is None else self.flat.unravel_fu(fu)


def prepare(prob, alg, *, abstol=None, reltol=None,
            termination_condition=None, precondition=None,
            postcondition=None, trace=None, verbosity=None,
            timer=None) -> Prepared:
    """Set ``prob`` up for ``alg`` (shared by ``solve_nonlinear`` and the
    iterator, ``core/cache.py``): the left preconditioner composed first,
    then the bounds' change of variable, the corrector on the iterate, the
    analytic derivatives and the sparse plan of the raw residual."""
    from .sensitivity import differentiable_leaves, strip_tangents
    kw = dict(abstol=abstol, reltol=reltol,
              termination_condition=termination_condition, trace=trace,
              verbosity=verbosity, timer=timer)
    if takes_flat_path(prob, alg):
        return _prepare_flat(prob, alg, precondition, postcondition, kw)
    u0, p = prob.u0, prob.p
    grad_index = differentiable_leaves(p)
    u0 = strip_tangents(u0).detach()
    p_run = strip_tangents(p)
    npdt = _backend.real_np_dtype(u0.dtype)
    is_lsq = prob.is_least_squares
    if termination_condition is None:
        termination_condition = default_termination_mode(
            is_lsq, getattr(alg, "default_termination_callee", "regular"))
    f = prob.f
    if precondition is not None:
        def f_eff(u, q):
            return precondition(f.f(u, q), u, q)
    else:
        f_eff = f.f

    bounds = None
    if prob.lb is not None or prob.ub is not None:
        from .bounds import (clamp_to_bounds, from_unbounded,
                             normalize_bounds, to_unbounded)
        bounds = normalize_bounds(prob.lb, prob.ub, u0)
        lbf, ubf = bounds
        x0 = to_unbounded(clamp_to_bounds(u0, lbf, ubf), lbf, ubf)

        def residual(t, q):
            return f_eff(from_unbounded(t, lbf, ubf), q)
    else:
        x0 = u0
        residual = f_eff

    def f_flat(u):
        return residual(u, p_run)

    with torch.no_grad():
        fu0 = f_flat(x0)
    if not isinstance(fu0, torch.Tensor):
        return _prepare_flat(prob, alg, precondition, postcondition, kw)
    ctx = DescentCtx(
        f_flat=f_flat, n_in=x0.numel(), n_out=fu0.numel(),
        is_least_squares=is_lsq, out_shape=tuple(fu0.shape),
        postcondition=_postcondition_of(postcondition, p_run, bounds),
        trace=trace, verbosity=verbosity, timer=timer)
    sparsity = f.sparsity if f.sparsity is not None else f.jac_prototype
    spec = JacobianSpec(
        analytic=(None if f.jac is None else (
            lambda u: f.jac(u, p_run).reshape(ctx.n_out, ctx.n_in))),
        analytic_jvp=(None if f.jvp is None
                      else (lambda v, u: f.jvp(v, u, p_run))),
        analytic_vjp=(None if f.vjp is None
                      else (lambda v, u: f.vjp(v, u, p_run))),
        sparsity=sparsity, colorvec=f.colorvec)
    with torch.no_grad():
        spec = dataclasses.replace(spec, sparse_plan=_maybe_sparse_plan(
            f, alg, spec, lambda u: f.f(u, p_run), ctx.n_in, ctx.n_out,
            u0))
    return Prepared(ctx=ctx, spec=spec, x0=x0, abstol=npdt(
        get_tolerance(abstol, npdt)), reltol=npdt(get_tolerance(reltol, npdt)),
        term_cfg=termination_condition, residual=residual, bounds=bounds,
        grad_index=grad_index)


def _prepare_flat(prob, alg, precondition, postcondition, kw) -> Prepared:
    """``prepare`` on the flat state: the problem, the conditioning and the
    bounds through ``FlatMap``; the engines then run on a 1-d tensor."""
    from .sensitivity import strip_tangents
    u0 = strip_tangents(prob.u0)
    fmap = FlatMap(u0, state_device(u0, prob.p))
    fmap.u0_flat = fmap.u0_flat.detach()
    prep = prepare(flat_problem(prob, fmap), alg,
                   precondition=fmap.precondition(precondition),
                   postcondition=fmap.postcondition(postcondition), **kw)
    prep.flat = fmap
    return prep


def solution_of(prob, prep: Prepared, carry, counters, trace=None,
                timer=None) -> NonlinearSolution:
    """The solution from an engine's final carry: the root joined to
    ``p``'s graph by the implicit-function rule when ``p`` carries a
    gradient, and mapped back from the unbounded variable."""
    from .sensitivity import differentiable_root
    u = carry.u
    if prep.grad_index:
        u = differentiable_root(u, prep.residual, prob.p, prep.grad_index,
                                square=carry.fu.numel() == u.numel())
    if prep.bounds is not None:
        from .bounds import from_unbounded
        u = from_unbounded(u, *prep.bounds)
    return NonlinearSolution(
        u=prep.to_tree(u), resid=prep.resid_tree(carry.fu),
        retcode=ReturnCode(carry.retcode),
        stats=carry.stats, counters=counters, trace=trace,
        timer=None if timer is None else timer.summarize())


def _state_scope(u0):
    """Around a solve of a state sharded on a mesh (a DTensor:
    ``parallel.distributed_solve``), plain tensors beside it — constants,
    p's leaves, the engines' host values — act as replicated, as
    unsharded arrays do under GSPMD."""
    from torch.distributed.tensor import DTensor
    if not isinstance(u0, DTensor):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def solve_nonlinear(prob, alg, *, abstol=None, reltol=None, maxiters=1000,
                    termination_condition=None, precondition=None,
                    postcondition=None, show_trace=False, store_trace=False,
                    trace_level=None, verbose=None, time_phases=False,
                    alias_u0=False, **extra) -> NonlinearSolution:
    if extra:
        check_kwargs(extra)
        raise TypeError(
            f"keyword argument(s) {sorted(extra)} are handled by the "
            f"solve() front door (maxtime/ensemble routing), not "
            f"solve_nonlinear(); call solve() instead")
    u0 = prob.u0
    if isinstance(u0, torch.Tensor) and u0.numel() == 0:
        return _null_solution(prob, abstol)
    with _state_scope(u0):
        # alias_u0 has no effect: the engine never writes into u0.  The
        # root depends on p alone: u0's and the bounds' tangents are zero.
        from .timer import PhaseTimer
        from .tracing import finalize_trace, trace_config
        from .verbosity import normalize_verbosity
        trace_cfg = trace_config(show_trace, store_trace, trace_level)
        verbosity = normalize_verbosity(verbose)
        _emit_solve_messages(verbosity, alias_u0, postcondition,
                             prob.lb is not None or prob.ub is not None)
        timer = None
        if time_phases:
            # the set-up counts as "other", up to the engine's first mark
            timer = PhaseTimer(state_device(u0, prob.p))
            timer.mark("other")
        prep = prepare(prob, alg, abstol=abstol, reltol=reltol,
                       termination_condition=termination_condition,
                       precondition=precondition,
                       postcondition=postcondition, trace=trace_cfg,
                       verbosity=verbosity, timer=timer)
        from ..solvers.dispatch import run_algorithm
        with torch.no_grad():
            syncs0 = _backend.HOST_SYNCS["n"]
            carry = run_algorithm(alg, prep.ctx, prep.term_cfg, prep.spec,
                                  prep.x0, prep.abstol, prep.reltol,
                                  int(maxiters))
            # DynamicSS and run_flat carries count no JVPs or Krylov steps
            counters = {"jvp": getattr(carry, "njvp", 0),
                        "krylov_iters": getattr(carry, "krylov_iters", 0),
                        "host_syncs": _backend.HOST_SYNCS["n"] - syncs0}
            if hasattr(carry, "winner"):
                counters["rungs"] = list(carry.rungs)
                counters["winner"] = carry.winner
        return solution_of(
            prob, prep, carry, counters,
            trace=finalize_trace(trace_cfg,
                                 getattr(carry, "trace_state", None)),
            timer=timer)

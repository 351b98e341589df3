"""The iterator: ``init`` / ``step`` / ``solve`` / ``reinit`` (the port of
``core/cache.py``).

    cache = init(prob, alg)
    cache.step()                 # one iteration
    sol = cache.solve()          # run to completion from the current state
    cache.reinit(u0=..., p=...)  # a warm reset for the next solve

The engines are already split into ``init_*`` / ``step_*`` and their
finishing pass (``solvers/first_order.py``, ``quasi_newton.py``,
``spectral.py``, ``anderson.py``); the cache drives them on a carry it
keeps, so ``init`` → ``step``s → ``solve`` makes the same operations, in
the same order, as one ``solve``.  ``solve(maxtime=...)`` advances in
chunks of ``_STEP_CHUNK`` steps and stops with ``ReturnCode.MaxTime``
once the host clock passes the budget (a chunk boundary maps no code and
keeps no best iterate).  A polyalgorithm cache solves whole and keeps the
rung that won as the next solve's start (``best_subalgorithm``), probing
the whole ladder again every 8th solve.  ``init`` of a ``HomotopyProblem``
returns a ``HomotopySolveCache`` (whole solves only).
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .. import _backend
from .returncode import ReturnCode
from .solution import NLStats, NonlinearSolution

_STEP_CHUNK = 16


class _Engine:
    """One engine's init, step and finish on a prepared problem."""

    def __init__(self, alg, prep):
        from ..solvers.anderson import AndersonAcceleration
        from ..solvers.first_order import GeneralizedFirstOrderAlgorithm
        from ..solvers.quasi_newton import (QuasiNewtonAlgorithm, flat_ctx,
                                            resolve_low_rank)
        from ..solvers.spectral import GeneralizedDFSane
        self.prep = prep
        self.shape = prep.x0.shape
        if isinstance(alg, GeneralizedFirstOrderAlgorithm):
            from .jacobian import construct_jacobian
            self.kind, self.ctx = "first_order", prep.ctx
            self.jac_fn, _ = construct_jacobian(
                alg.jacobian, alg.get_linsolve(), prep.ctx, prep.spec,
                alg.concrete_jac)
        elif isinstance(alg, (QuasiNewtonAlgorithm, GeneralizedDFSane,
                              AndersonAcceleration)):
            self.ctx, self.seen = flat_ctx(prep.ctx, self.shape)
            self.kind = next(kind for cls, kind in (
                (QuasiNewtonAlgorithm, "quasi_newton"),
                (GeneralizedDFSane, "dfsane"),
                (AndersonAcceleration, "anderson")) if isinstance(alg, cls))
            if self.kind == "quasi_newton":
                from .autodiff import construct_dense_jacobian_fn
                alg = resolve_low_rank(alg, prep.x0.numel())
                analytic = prep.spec.analytic
                shape = self.shape
                self.jac_fn = construct_dense_jacobian_fn(
                    self.ctx.f_flat, alg.jacobian, self.ctx.n_in,
                    self.ctx.n_out,
                    None if analytic is None
                    else (lambda v: analytic(v.reshape(shape))))
        else:
            raise ValueError(
                f"the iterator supports first-order, quasi-Newton, spectral "
                f"and Anderson algorithms, got {alg!r}")
        self.alg = alg

    def init(self):
        from ..solvers import anderson, first_order, quasi_newton, spectral
        p, a, c = self.prep, self.alg, self.ctx
        if self.kind == "first_order":
            return first_order.init_first_order(a, c, p.term_cfg, p.x0,
                                                p.reltol)
        x0 = p.x0.reshape(-1)
        if self.kind == "quasi_newton":
            return quasi_newton.init_quasi_newton(a, c, p.term_cfg,
                                                  self.jac_fn, x0, p.reltol)
        if self.kind == "dfsane":
            return spectral.init_dfsane(a, c, p.term_cfg, x0, p.reltol)
        return anderson.init_anderson(a, c, p.term_cfg, x0, p.reltol)

    def step(self, carry):
        from ..solvers import anderson, first_order, quasi_newton, spectral
        p, a, c = self.prep, self.alg, self.ctx
        if self.kind == "first_order":
            return first_order.step_first_order(
                a, c, p.term_cfg, self.jac_fn, carry, p.abstol, p.reltol)
        if self.kind == "quasi_newton":
            return quasi_newton.step_quasi_newton(
                a, c, p.term_cfg, self.jac_fn, carry, p.abstol, p.reltol)
        if self.kind == "dfsane":
            return spectral.step_dfsane(a, c, p.term_cfg, carry, p.abstol,
                                        p.reltol)
        return anderson.step_anderson(a, c, p.term_cfg, carry, p.abstol,
                                      p.reltol)

    def finish(self, carry, maxiters):
        """Default → MaxIters or Success, and the safe-best iterate; the
        state and residual in their shapes."""
        from ..solvers.first_order import finalize_first_order
        from ..solvers.quasi_newton import finish
        if self.kind == "first_order":
            return finalize_first_order(self.ctx, self.prep.term_cfg,
                                        carry, maxiters)
        return finish(carry, self.ctx, self.prep.term_cfg, maxiters,
                      self.shape, self.seen)

    def shaped(self, u):
        return u.reshape(self.shape)


class NonlinearSolveCache:
    """A solve in progress: the prepared problem, the engine and its
    carry."""

    _REPROBE_EVERY = 8

    def __init__(self, prob, alg, *, abstol=None, reltol=None, maxiters=1000,
                 termination_condition=None):
        from ..solvers.polyalg import NonlinearSolvePolyAlgorithm
        init_data = getattr(prob.f, "initialization_data", None)
        if init_data is not None:
            from .initialization import run_initialization
            prob, init_sol, ok = run_initialization(prob, init_data)
            if not ok:
                raise RuntimeError(
                    "initialization problem failed to converge "
                    f"(retcode={int(init_sol.retcode)}); cannot build a "
                    "solver cache from an inconsistent state")
        self.prob, self.alg = prob, alg
        self._tol = {"abstol": abstol, "reltol": reltol,
                     "termination_condition": termination_condition}
        self.maxiters = int(maxiters)
        self._is_polyalg = isinstance(alg, NonlinearSolvePolyAlgorithm)
        self._winner = None
        self._nsolves = 0
        self._build()

    def _build(self):
        from .solve import prepare
        self._prep = prepare(self.prob, self.alg, **self._tol)
        if self._is_polyalg:
            # no per-step carry: the accessors show u0 until a solve
            self._engine, self.carry = None, None
            return
        self._engine = _Engine(self.alg, self._prep)
        with torch.no_grad():
            self.carry = self._engine.init()

    # -- accessors --------------------------------------------------------
    @property
    def u(self):
        if self.carry is None:
            return self.prob.u0
        return self._prep.to_tree(self._engine.shaped(self.carry.u))

    @property
    def fu(self):
        if self.carry is None:
            with torch.no_grad():
                fu = self._prep.ctx.f_flat(self._prep.x0)
        else:
            fu = self.carry.fu
        return self._prep.resid_tree(fu)

    @property
    def nsteps(self) -> int:
        if self.carry is None:
            return 0
        return int(self.carry.nsteps)

    @property
    def retcode(self):
        if self.carry is None:
            return ReturnCode.Default
        return ReturnCode(int(self.carry.retcode))

    @property
    def stats(self):
        return NLStats() if self.carry is None else self.carry.stats

    @property
    def best_subalgorithm(self):
        """The retained winning rung of a polyalgorithm cache, or None
        before a successful solve."""
        return self._winner

    # -- iteration ----------------------------------------------------------
    def step(self, n: int = 1):
        """Advance ``n`` iterations (no more once the solve has stopped)."""
        if self._is_polyalg:
            raise NotImplementedError(
                "per-step iteration of a polyalgorithm cache is not "
                "supported — use solve(); the winning subalgorithm is "
                "retained across reinit()/solve() cycles")
        with torch.no_grad():
            for _ in range(n):
                if self.carry.force_stop:
                    break
                self.carry = self._engine.step(self.carry)
        return self

    def _advance(self, upto: int):
        with torch.no_grad():
            while not self.carry.force_stop and self.carry.nsteps < upto:
                self.carry = self._engine.step(self.carry)

    def solve(self, maxtime: Optional[float] = None) -> NonlinearSolution:
        """Run to completion from the current state; with ``maxtime``
        (seconds on the host clock), in chunks of steps, stopping with
        ``ReturnCode.MaxTime`` once the budget is spent."""
        if self._is_polyalg:
            if maxtime is not None:
                raise NotImplementedError(
                    "maxtime is not supported for polyalgorithm caches "
                    "(the ladder runs as one solve); set maxiters or use a "
                    "single-algorithm cache")
            return self._polyalg_solve()
        syncs0 = _backend.HOST_SYNCS["n"]
        # a previous MaxTime stop is a budget, not solver state
        if int(self.carry.retcode) == int(ReturnCode.MaxTime):
            self.carry = self.carry.replace(retcode=int(ReturnCode.Default),
                                            force_stop=False)
        if maxtime is None:
            self._advance(self.maxiters)
        else:
            deadline = time.monotonic() + float(maxtime)
            while (not self.carry.force_stop
                   and self.carry.nsteps < self.maxiters):
                if time.monotonic() >= deadline:
                    self.carry = self.carry.replace(
                        retcode=int(ReturnCode.MaxTime), force_stop=True)
                    break
                self._advance(min(self.maxiters,
                                  self.carry.nsteps + _STEP_CHUNK))
        with torch.no_grad():
            self.carry = self._engine.finish(self.carry, self.maxiters)
        return self._solution(syncs0)

    def _solution(self, syncs0) -> NonlinearSolution:
        from .solve import solution_of
        carry = self.carry
        counters = {"jvp": getattr(carry, "njvp", 0),
                    "krylov_iters": getattr(carry, "krylov_iters", 0),
                    "host_syncs": _backend.HOST_SYNCS["n"] - syncs0}
        if self._engine is not None:
            carry = carry.replace(u=self._engine.shaped(carry.u))
        return solution_of(self.prob, self._prep, carry, counters)

    def _polyalg_solve(self) -> NonlinearSolution:
        from ..solvers.polyalg import run_polyalg
        hint = (0 if self._winner is None
                or self._nsolves % self._REPROBE_EVERY == 0
                else self._winner)
        syncs0 = _backend.HOST_SYNCS["n"]
        p = self._prep
        with torch.no_grad():
            carry = run_polyalg(self.alg, p.ctx, p.term_cfg, p.spec, p.x0,
                                p.abstol, p.reltol, self.maxiters,
                                start_hint=hint)
        self._nsolves += 1
        self._winner = carry.winner if carry.winner >= 0 else None
        from .solve import solution_of
        counters = {"jvp": carry.njvp, "krylov_iters": carry.krylov_iters,
                    "host_syncs": _backend.HOST_SYNCS["n"] - syncs0,
                    "rungs": list(carry.rungs), "winner": carry.winner}
        return solution_of(self.prob, self._prep, carry, counters)

    def reinit(self, u0=None, *, p=None, abstol=None, reltol=None,
               maxiters=None):
        """A warm reset for the next solve: the carry rebuilt at the new
        (u0, p); a polyalgorithm keeps its winning rung."""
        if u0 is not None:
            self.prob = self.prob.remake(u0=u0)
        if p is not None:
            self.prob = self.prob.remake(p=p)
        if abstol is not None:
            self._tol["abstol"] = abstol
        if reltol is not None:
            self._tol["reltol"] = reltol
        if maxiters is not None:
            self.maxiters = int(maxiters)
        self._build()
        return self


class HomotopySolveCache:
    """``init`` / ``reinit`` / ``solve`` of a continuation method: ``init``
    keeps the problem, the algorithm and the options; ``reinit`` swaps
    u0, p, lambdaspan and the tolerances; ``solve`` runs the whole
    continuation.  A method's step is a λ-advance with its own corrector,
    so the cache has no per-step iteration."""

    def __init__(self, prob, alg=None, **kwargs):
        self.prob = prob
        self.alg = alg
        self.kwargs = dict(kwargs)

    def reinit(self, u0=None, *, p=None, abstol=None, reltol=None,
               maxiters=None, lambdaspan=None):
        remake_kw = {}
        if u0 is not None:
            remake_kw["u0"] = u0
        if p is not None:
            remake_kw["p"] = p
        if lambdaspan is not None:
            remake_kw["lambdaspan"] = lambdaspan
        if remake_kw:
            self.prob = self.prob.remake(**remake_kw)
        for k, v in (("abstol", abstol), ("reltol", reltol),
                     ("maxiters", maxiters)):
            if v is not None:
                self.kwargs[k] = v
        return self

    def solve(self) -> NonlinearSolution:
        from .solve import solve
        return solve(self.prob, self.alg, **self.kwargs)

    def step(self, *_args, **_kwargs):
        raise NotImplementedError(
            "HomotopySolveCache has no per-step iteration: continuation "
            "methods expose whole-solve granularity (call .solve())")

    def __iter__(self):
        raise NotImplementedError(
            "HomotopySolveCache is not iterable: continuation methods "
            "expose whole-solve granularity — call .solve()")


def init(prob, alg=None, **kwargs):
    """A solver cache for ``prob``: a ``HomotopySolveCache`` for a
    ``HomotopyProblem``, else a ``NonlinearSolveCache`` (``NewtonRaphson``
    by default)."""
    from .problems import HomotopyProblem
    if isinstance(prob, HomotopyProblem):
        return HomotopySolveCache(prob, alg, **kwargs)
    if alg is None:
        from ..solvers.first_order import NewtonRaphson
        alg = NewtonRaphson()
    return NonlinearSolveCache(prob, alg, **kwargs)

"""Polynomial-system solving by total-degree homotopy continuation (the
port of ``solvers/poly_homotopy.py``): all isolated complex roots of a
square polynomial system, or the root closest to a guess.

Method (the classical total-degree construction):
  start system   g_i(x) = x_i^{d_i} - 1        (roots: roots of unity grid)
  homotopy       H(x, t) = (1-t)·γ·g(x) + t·f(x),  γ random complex
                 (the "gamma trick": for almost every γ the ∏d_i paths are
                 nonsingular for t ∈ [0, 1))
  tracking       adaptive-step predictor–corrector per path: Euler predictor
                 x += dt·ẋ with ẋ from H_x ẋ = -H_t, then a fixed number of
                 complex Newton corrections at fixed t; dt halves on
                 corrector failure and grows on streaks.

The JAX package tracks each path in a ``lax.while_loop`` and maps the
paths with ``vmap``.  Here every path is a row of one lockstep batch on the
device of ``u0``: each row keeps its own t, dt, step count and done /
failed flags, a step is taken by the rows still running and discarded for
the others, and the loop reads one flag a step (is any row still
running?).  The Jacobians H_x are holomorphic (``vmap`` of ``jvp`` over
the unit tangents, ``core/autodiff.py``) and the batched complex solves
are the JAX package's ``_square_solve``: Gauss–Jordan for n ≤ 32 (one
CUDA graph a shape on the card), LU above.  A row's arithmetic is its own,
so a path of the batch is its lone track bit for bit.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from .. import _backend
from ..core.autodiff import jvp
from ..core.returncode import ReturnCode
from ..core.solution import NLStats, NonlinearSolution
from ..ops.linear_solve import _batched_square_solve


@dataclasses.dataclass(frozen=True)
class PolynomialHomotopy:
    """All-roots (or nearest-root) polynomial solver.

    degrees: per-equation total degrees d_i (Bézout bound ∏ d_i paths).
    """

    degrees: Tuple[int, ...] = ()
    gamma_seed: int = 0
    corrector_iters: int = 8
    corrector_tol: float = 1e-8
    dt_initial: float = 0.05
    dt_min: float = 1e-7
    maxsteps: int = 2000
    endgame_tol: float = 1e-8
    name: str = "PolynomialHomotopy"

    def replace(self, **kw) -> "PolynomialHomotopy":
        return dataclasses.replace(self, **kw)


def _start_roots(degrees: Sequence[int], dtype=torch.complex64,
                 device=None) -> torch.Tensor:
    """All combinations of d_i-th roots of unity: (∏d_i, n) complex."""
    roots_per_var = [np.exp(2j * np.pi * np.arange(d) / d) for d in degrees]
    combos = list(itertools.product(*roots_per_var))
    return torch.as_tensor(np.array(combos), dtype=dtype, device=device)


def _gamma(seed: int) -> complex:
    """γ = exp(iθ), θ uniform on [0, 2π) from a numpy generator of
    ``seed`` (the JAX package's draw)."""
    theta = np.random.default_rng(seed).uniform(0, 2 * np.pi)
    return complex(np.exp(1j * theta))


@dataclasses.dataclass
class TrackStats:
    """What a tracking run did: lockstep steps, host reads, and per path
    its own step count (the JAX package's ``steps``)."""

    loop_steps: int = 0
    host_reads: int = 0


def _track_paths(f_cplx: Callable, degrees, alg: PolynomialHomotopy,
                 dtype=torch.complex64, device=None, starts=None,
                 stats: TrackStats = None):
    """Track the total-degree paths from ``starts`` (all ∏d_i start roots
    by default) in one lockstep batch; returns (endpoints (P, n),
    success (P,), steps (P,))."""
    if starts is None:
        starts = _start_roots(degrees, dtype, device)
    device = starts.device
    rdt = _backend.real_dtype(dtype)
    gamma = torch.tensor(_gamma(alg.gamma_seed), dtype=dtype, device=device)
    degs = torch.as_tensor(np.array(degrees), dtype=dtype, device=device)

    def f(x):
        # below complex128 a copy in the state's dtype: under
        # torch.func.jvp a 0-d complex64 term combined with a Python float
        # carries a complex128 tangent (ROADMAP C), which would promote
        # the Newton step and then the paths
        out = f_cplx(x)
        return out if dtype == torch.complex128 else out.to(dtype, copy=True)

    def g(x):
        return x ** degs - 1.0

    def H(x, t):
        return (1.0 - t) * gamma * g(x) + t * f(x)

    def H_t(x, t):
        return f(x) - gamma * g(x)

    def H_and_H_x(x, t):
        """(H, H_x) at (x, t) from one pass of JVPs on the unit tangents
        (the primal rounds as H(x, t) alone does)."""
        n = x.shape[-1]
        eye = torch.eye(n, dtype=x.dtype, device=x.device)
        vals, cols = torch.func.vmap(
            lambda e: jvp(lambda y: H(y, t), x, e))(eye)
        return vals[0], cols.T

    Htb, HJb = torch.func.vmap(H_t), torch.func.vmap(H_and_H_x)

    def Jb(x, t):
        return HJb(x, t)[1]

    def finite_rows(z):
        return (torch.isfinite(z.real) & torch.isfinite(z.imag)).all(-1)

    def corrector(x, t):
        ok = torch.ones(x.shape[0], dtype=torch.bool, device=device)
        dx_norm = torch.full((x.shape[0],), float("inf"), dtype=rdt,
                             device=device)
        for _ in range(alg.corrector_iters):
            r, J = HJb(x, t)
            dx = _batched_square_solve(J, r)
            finite = finite_rows(dx)
            x = torch.where(finite[:, None], x - dx, x)
            dx_norm = torch.where(finite, dx.abs().amax(-1), dx_norm)
            ok = ok & finite
        # Newton-increment convergence: robust to wildly scaled polynomial
        # values (a residual test fails on e.g. Wilkinson-type products)
        scale = 1.0 + x.abs().amax(-1)
        return x, ok & (dx_norm <= alg.corrector_tol * scale)

    P = starts.shape[0]
    x = starts
    t = torch.zeros(P, dtype=rdt, device=device)
    dt = torch.full((P,), alg.dt_initial, dtype=rdt, device=device)
    steps = torch.zeros(P, dtype=torch.int32, device=device)
    done = torch.zeros(P, dtype=torch.bool, device=device)
    failed = torch.zeros(P, dtype=torch.bool, device=device)
    running = True
    while running:
        active = ~(done | failed)
        t_next = torch.clamp(t + dt, max=1.0)
        # Euler predictor: H_x ẋ = -H_t
        xdot = -_batched_square_solve(Jb(x, t), Htb(x, t))
        finite = torch.isfinite(xdot.real).all(-1)
        x_pred = torch.where(finite[:, None],
                             x + (t_next - t)[:, None] * xdot, x)
        x_corr, ok = corrector(x_pred, t_next)
        ok = ok & finite
        x_new = torch.where(ok[:, None], x_corr, x)
        t_new = torch.where(ok, t_next, t)
        # slow down in the endgame region: paths cluster as t → 1, so the
        # step is additionally capped by a fraction of (1 - t)
        dt_cap = torch.clamp(0.25 * (1.0 - t_next), min=5e-3)
        dt_new = torch.where(ok, torch.minimum(
            torch.clamp(dt * 1.5, max=0.1), dt_cap), dt / 2.0)
        steps_new = steps + 1
        done_new = ok & (t_next >= 1.0)
        failed_new = ((~ok & (dt_new < alg.dt_min))
                      | (steps_new >= alg.maxsteps))
        # the rows that had stopped keep their state
        x = torch.where(active[:, None], x_new, x)
        t = torch.where(active, t_new, t)
        dt = torch.where(active, dt_new, dt)
        steps = torch.where(active, steps_new, steps)
        done = torch.where(active, done_new, done)
        failed = torch.where(active, failed_new, failed)
        running = bool(_backend.fetch((~(done | failed)).any())[0])
        if stats is not None:
            stats.loop_steps += 1
            stats.host_reads += 1
    # endgame: polish at t = 1 on the target system
    x, polished = corrector(x, torch.ones(P, dtype=rdt, device=device))
    return x, done & polished, steps


def _dedupe_into(uniq: list, roots: np.ndarray, tol: float) -> list:
    """Append to ``uniq`` each row of ``roots`` farther than
    ``tol·(1 + max|q|)`` (max norm) from every root kept so far, in
    order."""
    kept = list(uniq)
    for r in roots:
        if kept:
            Q = np.asarray(kept)
            near = np.max(np.abs(r[None] - Q), axis=1) < tol * (
                1 + np.max(np.abs(Q), axis=1))
            if near.any():
                continue
        kept.append(r)
    return kept


def solve_polynomial(prob, alg: PolynomialHomotopy, *, all_roots: bool = True,
                     real_only: bool = False, imag_tol: float = 1e-6,
                     dedupe_tol: float = 1e-6, gamma_retries: int = 4,
                     **_ignored):
    """Solve a polynomial ``NonlinearProblem`` (its residual takes one
    path's complex state, (n,), and ``p``; write it with ``torch.stack``,
    it runs under ``torch.func.vmap``).

    all_roots=True → ``sol.u`` is an (n_roots, n) tensor of distinct roots
    (``sol.original`` holds every tracked endpoint and its success flag);
    otherwise the root closest to ``prob.u0`` is returned.  Paths are
    tracked in complex128 for an f64 ``u0`` and complex64 for f32.  Path
    jumping loses roots under one γ, so the tracking reruns with fresh γ
    (seed + 7919·k) until the Bézout count of distinct roots is reached
    or ``gamma_retries`` runs are spent (``sol.original`` is the last
    run's).  ``sol.counters``: the lockstep steps and host reads of all
    runs, and the number of runs.
    """
    from ..core.solve import state_tensor
    if not alg.degrees:
        raise ValueError("PolynomialHomotopy requires per-equation degrees")
    u0 = state_tensor(prob.u0, prob.p)
    real_dtype = u0.dtype
    dtype = (torch.complex128 if real_dtype == torch.float64
             else torch.complex64)
    np_real = _backend.np_dtype(real_dtype)
    dev = u0.device
    f, p = prob.f.f, prob.p
    bezout = int(np.prod(alg.degrees))
    total_steps = 0
    track = TrackStats()

    uniq: list = []
    endpoints = ok = None
    for attempt in range(max(1, int(gamma_retries))):
        alg_a = alg if attempt == 0 else alg.replace(
            gamma_seed=alg.gamma_seed + 7919 * attempt)
        with torch.no_grad():
            endpoints, ok, steps = _track_paths(
                lambda x: f(x, p), alg.degrees, alg_a, dtype, dev,
                stats=track)
        host_x, host_ok, host_steps = (_backend.to_host(endpoints),
                                       _backend.to_host(ok),
                                       _backend.to_host(steps))
        track.host_reads += 3
        total_steps += int(host_steps.sum())
        uniq = _dedupe_into(uniq, host_x[host_ok], dedupe_tol)
        if len(uniq) >= bezout:
            break
    uniq = (np.array(uniq) if uniq
            else np.zeros((0, u0.numel()), np.complex128))
    if real_only:
        mask = np.all(np.abs(uniq.imag) < imag_tol, axis=1)
        uniq = uniq[mask].real.astype(np_real)

    n_found = len(uniq)
    retcode = ReturnCode.Success if n_found > 0 else ReturnCode.Failure
    stats = NLStats(nsteps=total_steps)
    counters = {"loop_steps": track.loop_steps,
                "host_syncs": track.host_reads, "gamma_runs": attempt + 1}
    if all_roots:
        return NonlinearSolution(
            u=torch.as_tensor(uniq, device=dev),
            resid=torch.zeros((n_found,), dtype=real_dtype, device=dev),
            retcode=retcode, stats=stats, original=(endpoints, ok),
            counters=counters)
    if n_found == 0:
        return NonlinearSolution(u=u0, resid=f(u0, p),
                                 retcode=ReturnCode.Failure, stats=stats,
                                 counters=counters)
    dists = np.max(np.abs(uniq - _backend.to_host(u0)[None]), axis=1)
    best = uniq[int(np.argmin(dists))]
    u_best = torch.as_tensor(np.asarray(best.real if np.iscomplexobj(best)
                                        else best).astype(np_real),
                             device=dev)
    return NonlinearSolution(
        u=u_best, resid=f(u_best, p), retcode=retcode, stats=stats,
        original=(endpoints, ok), counters=counters)

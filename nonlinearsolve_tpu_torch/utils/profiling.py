"""Time-to-solve and trace helpers (the port of ``utils/profiling.py``).

* ``profile_solve`` — one warm solve under ``torch.profiler`` (CPU and,
  when the problem lies on the card, CUDA activity); the profile's
  ``key_averages()`` give the device time by kernel.
* ``chained_solve_time`` — per-solve marginal seconds by the chain-length
  slope: chains of 1 and k solves, each solve's ``u0`` data-dependent on the
  previous root, completion forced by fetching a scalar, and the
  paired-median slope ``(T_k − T_1)/(k − 1)`` taken so every fixed term
  (set-up, the fetch) cancels.
* ``slope_time`` — the paired-median slope estimator both build on.

The load-calibration probes of the JAX module (``hbm_triad_probe``,
``vpu_issue_probe``) belong to the port bench (ROADMAP D.1).
"""

from __future__ import annotations

import time


def slope_time(run_short, run_long, span: int, rounds: int = 5) -> float:
    """Paired-median chain-length slope: seconds of marginal work per unit
    of ``span``.  ``run_short`` / ``run_long`` run the SAME computation at
    two chain lengths that differ by ``span`` and force completion
    themselves (fetch a scalar).  Each round times the pair back to back;
    the median round slope is kept (a single round can land in a burst of
    load on either side), floored at 0."""
    slopes = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        run_short()
        ts = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_long()
        tl = time.perf_counter() - t0
        slopes.append((tl - ts) / span)
    slopes.sort()
    return max(slopes[len(slopes) // 2], 0.0)


def chained_solve_time(prob, alg=None, k: int = 4, reps: int = 3,
                       **solve_kwargs) -> float:
    """Per-solve marginal seconds: ``slope_time`` over chains of 1 and
    ``k`` data-dependent solves (``u0 + 0·u_prev``), each chain ended by a
    scalar fetch."""
    from ..core.solve import solve

    if k < 2:
        raise ValueError("slope timing needs k >= 2")
    u0 = prob.u0

    def chained(n):
        acc = u0
        for _ in range(n):
            acc = solve(prob.remake(u0=u0 + 0.0 * acc), alg,
                        **solve_kwargs).u
        return float(acc.abs().sum(dtype=acc.dtype))

    chained(1)                                   # warm caches and plans
    chained(k)
    return slope_time(lambda: chained(1), lambda: chained(k), span=k - 1,
                      rounds=reps)


def profile_solve(prob, alg=None, trace_path=None, **solve_kwargs):
    """Run one warm solve (after one untraced solve) under
    ``torch.profiler``.  Returns ``(solution, profile)``; with
    ``trace_path`` the profile is also written there as a Chrome trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core.solve import solve

    on_card = prob.u0.device.type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    sol = solve(prob, alg, **solve_kwargs)
    if on_card:
        torch.cuda.synchronize(prob.u0.device)
    with profile(activities=activities) as prof:
        sol = solve(prob, alg, **solve_kwargs)
        if on_card:
            torch.cuda.synchronize(prob.u0.device)
    if trace_path is not None:
        prof.export_chrome_trace(str(trace_path))
    return sol, prof

"""Run one algorithm (the port of ``solvers/dispatch.py``): the first-order
engine.  Quasi-Newton, spectral and Anderson engines are ROADMAP A.14,
polyalgorithms A.15 and the simple solvers A.17."""

from __future__ import annotations


def run_algorithm(alg, ctx, term_cfg, jac_spec, u0, abstol, reltol,
                  maxiters):
    """Run ``alg`` to completion; returns the engine's final carry (fields:
    u, fu, retcode, stats)."""
    from .first_order import GeneralizedFirstOrderAlgorithm, run_first_order
    if isinstance(alg, GeneralizedFirstOrderAlgorithm):
        return run_first_order(alg, ctx, term_cfg, jac_spec, u0, abstol,
                               reltol, maxiters)
    raise NotImplementedError(
        f"cannot dispatch {type(alg).__name__}: the port runs the first-order "
        f"engine only; the others are ROADMAP A.14, A.15 and A.17")

"""Run one algorithm (the port of ``solvers/dispatch.py``), shared by the
top-level solve and the polyalgorithm: the first-order, quasi-Newton,
spectral and Anderson engines, the polyalgorithms and the simple tier (a
batch of one).  ``DynamicSS`` and user algorithms with a ``run_flat`` hook
are ROADMAP A.30."""

from __future__ import annotations


def run_algorithm(alg, ctx, term_cfg, jac_spec, u0, abstol, reltol,
                  maxiters):
    """Run ``alg`` to completion; returns the engine's final carry (fields:
    u, fu, retcode, stats).  ``jac_spec`` is a ``core.jacobian.JacobianSpec``
    (or None)."""
    from .anderson import AndersonAcceleration, run_anderson
    from .first_order import GeneralizedFirstOrderAlgorithm, run_first_order
    from .polyalg import NonlinearSolvePolyAlgorithm, run_polyalg
    from .quasi_newton import QuasiNewtonAlgorithm, run_quasi_newton
    from .simple import is_simple_alg, run_simple
    from .spectral import GeneralizedDFSane, run_dfsane

    analytic_jac = jac_spec.analytic if jac_spec is not None else None
    if isinstance(alg, GeneralizedFirstOrderAlgorithm):
        return run_first_order(alg, ctx, term_cfg, jac_spec, u0, abstol,
                               reltol, maxiters)
    if isinstance(alg, QuasiNewtonAlgorithm):
        return run_quasi_newton(alg, ctx, term_cfg, analytic_jac, u0,
                                abstol, reltol, maxiters)
    if isinstance(alg, GeneralizedDFSane):
        return run_dfsane(alg, ctx, term_cfg, u0, abstol, reltol, maxiters)
    if isinstance(alg, AndersonAcceleration):
        return run_anderson(alg, ctx, term_cfg, u0, abstol, reltol,
                            maxiters)
    if isinstance(alg, NonlinearSolvePolyAlgorithm):
        return run_polyalg(alg, ctx, term_cfg, jac_spec, u0, abstol, reltol,
                           maxiters)
    if is_simple_alg(alg):
        return run_simple(alg, ctx, term_cfg, analytic_jac, u0, abstol,
                          reltol, maxiters)
    name = type(alg).__name__
    if name == "DynamicSS" or hasattr(alg, "run_flat"):
        raise NotImplementedError(
            f"cannot dispatch {name}: DynamicSS and algorithms with a "
            f"run_flat hook are ROADMAP A.30")
    raise ValueError(f"cannot dispatch algorithm {alg!r}")

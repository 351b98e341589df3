"""Run one algorithm (the port of ``solvers/dispatch.py``), shared by the
top-level solve and the polyalgorithm: the first-order, quasi-Newton,
spectral and Anderson engines, the polyalgorithms, ``DynamicSS``, the
simple tier (a batch of one) and user algorithms: any object with a
``run_flat`` method (``solvers/custom.py``)."""

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

    _refuse_complex(alg, u0)
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
    from .steady_state import DynamicSS, run_dynamic_ss
    if isinstance(alg, DynamicSS):
        return run_dynamic_ss(alg, ctx, term_cfg, u0, abstol, reltol,
                              maxiters)
    if is_simple_alg(alg):
        return run_simple(alg, ctx, term_cfg, analytic_jac, u0, abstol,
                          reltol, maxiters)
    if hasattr(alg, "run_flat"):
        from .custom import run_custom
        return run_custom(alg, ctx, term_cfg, u0, abstol, reltol, maxiters)
    raise ValueError(f"cannot dispatch algorithm {alg!r}")


def _refuse_complex(alg, u0) -> None:
    """The JAX package runs every engine on a complex state, ordering
    complex values lexicographically (``utils/ordering.py``), but for
    that fail to trace there: ``PseudoTransient`` (its SER damping
    carries a complex residual norm into a real one), a trust region
    under the NLsolve or Fan radius scheme (a real initial radius updated
    into a complex one) and so ``RobustMultiNewton``, which holds both
    schemes.  The port refuses those, as the reference does not run
    them."""
    if not u0.is_complex():
        return
    from ..core.descent import DampedNewtonDescent
    from ..core.damping import SwitchedEvolutionRelaxation
    from .first_order import GeneralizedFirstOrderAlgorithm
    from .polyalg import NonlinearSolvePolyAlgorithm
    descent = getattr(alg, "descent", None)
    ser = (isinstance(alg, GeneralizedFirstOrderAlgorithm)
           and isinstance(descent, DampedNewtonDescent)
           and isinstance(descent.damping, SwitchedEvolutionRelaxation))
    tr = getattr(alg, "trustregion", None)
    real_radius = getattr(tr, "method", None) in ("nlsolve", "fan")
    robust = (isinstance(alg, NonlinearSolvePolyAlgorithm)
              and getattr(alg, "name", "") == "RobustMultiNewton")
    if ser or real_radius or robust:
        raise NotImplementedError(
            f"{getattr(alg, 'name', type(alg).__name__)} on a complex state: "
            f"the JAX package fails to trace it there too, so there is no "
            f"reference result to hold it to")

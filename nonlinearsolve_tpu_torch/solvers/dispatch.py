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
    """The engines that order or compare values (a trust region, LM or
    SER damping, Anderson's safeguard, the simple trust region and
    DFSane's line search) run on real states only: on a complex one the
    JAX package orders complex numbers, which torch refuses."""
    if not u0.is_complex():
        return
    from ..core.descent import DampedNewtonDescent, GeodesicAcceleration
    from .anderson import AndersonAcceleration
    from .first_order import GeneralizedFirstOrderAlgorithm
    from .quasi_newton import QuasiNewtonAlgorithm
    from .simple import SimpleDFSane, SimpleTrustRegion
    descent = getattr(alg, "descent", None)
    while isinstance(descent, GeodesicAcceleration):
        descent = descent.descent
    ordered = (isinstance(alg, (AndersonAcceleration, SimpleTrustRegion,
                                SimpleDFSane))
               or (isinstance(alg, (GeneralizedFirstOrderAlgorithm,
                                    QuasiNewtonAlgorithm))
                   and (alg.trustregion is not None
                        or isinstance(descent, DampedNewtonDescent))))
    if ordered:
        raise NotImplementedError(
            f"{getattr(alg, 'name', type(alg).__name__)} on a complex state "
            f"is ROADMAP A.33 (it orders complex values)")

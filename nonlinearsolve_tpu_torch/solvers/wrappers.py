"""External-solver bridges (the port of ``solvers/wrappers.py``).

* ``SciPyRoot`` / ``SciPyRootScalar`` / ``SciPyLeastSquares``: the
  problem flattened into the ``f(x) -> resid`` shape ``scipy.optimize``
  expects (``construct_extension_function_wrapper``), run on the host.
  The residual and the dense Jacobian callback run on the problem's
  device; only x, f(x) and J(x) cross to numpy, each a host sync counted
  by ``_backend``.  The solution's ``u`` and ``resid`` are tensors on the
  problem's device.
* The reference's other bridges (PETSc SNES, Sundials KINSOL, MINPACK,
  NLsolve.jl, NLSolvers.jl, SIAMFANLEquations.jl, LeastSquaresOptim.jl,
  FastLevenbergMarquardt.jl, SpeedMapping.jl, FixedPointAcceleration.jl)
  wrap external binaries that are not here.  Their constructors accept
  the reference's signatures and return the native algorithm that
  implements the same method (``CMINPACK(method=:hybr)`` → ``TrustRegion()``,
  ``NLsolveJL(method=:anderson, m=8)`` → ``AndersonAcceleration(m=8)``);
  keyword arguments the delegation cannot honor are reported by the
  ``dropped_extension_kwarg`` message.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import _backend
from ..core.returncode import ReturnCode
from ..core.solution import NLStats, NonlinearSolution


@dataclasses.dataclass(frozen=True)
class SciPyRoot:
    """``scipy.optimize.root``; method: hybr | lm | broyden1 | broyden2 |
    anderson | krylov | df-sane ..."""

    method: str = "hybr"
    name: str = "SciPyRoot"


@dataclasses.dataclass(frozen=True)
class SciPyRootScalar:
    """``scipy.optimize.root_scalar`` on an ``IntervalNonlinearProblem``."""

    method: str = "brentq"
    name: str = "SciPyRootScalar"


@dataclasses.dataclass(frozen=True)
class SciPyLeastSquares:
    """``scipy.optimize.least_squares``: trf / dogbox / lm × robust
    losses."""

    method: str = "trf"
    loss: str = "linear"
    name: str = "SciPyLeastSquares"


def SciPyLeastSquaresTRF(**kwargs):
    """The trust-region-reflective preset."""
    return SciPyLeastSquares(method="trf", **kwargs)


def SciPyLeastSquaresDogbox(**kwargs):
    """The dogleg-with-box preset."""
    return SciPyLeastSquares(method="dogbox", **kwargs)


# ---------------------------------------------------------------------------
# The reference's extension-algorithm constructors → native delegation.
# Symbols may be passed as Julia-style strings with or without a leading
# colon (":newton" or "newton").
# ---------------------------------------------------------------------------

def _sym(x, default):
    if x is None:
        return default
    s = str(x).lstrip(":").lower()
    return s or default


def _warn_dropped(constructor: str, dropped, **named):
    """Emit a visible notice when a delegating bridge constructor is handed
    reference kwargs the native delegation cannot honor (the reference's
    wrappers forward these to the external binary; here they'd be silently
    meaningless).  Routed through the ``dropped_extension_kwarg`` verbosity
    class (on in the minimal/standard presets) so
    ``NonlinearVerbosity("none")``-style global silencing stays possible via
    ``nonlinearsolve_tpu_torch.solvers.wrappers.CONSTRUCTOR_VERBOSITY``.

    ``dropped``: everything that arrived via ``**ignored`` — reported
    REGARDLESS of value (an explicit ``KINSOL(foo=None)`` is still a user
    intent the delegation drops).  ``named``: the constructor's
    declared parameters that default to None — only reported when set."""
    names = set(dropped)
    names |= {k for k, v in named.items() if v is not None}
    if not names:
        return
    CONSTRUCTOR_VERBOSITY.emit(
        "dropped_extension_kwarg",
        f"{constructor}: native delegation ignores kwargs "
        f"{sorted(names)} (no external binary in this build)")


from ..core.verbosity import NonlinearVerbosity as _NV  # noqa: E402

#: verbosity used for constructor-time notices (constructors run before
#: ``solve()`` sees a ``verbose=`` kwarg).  Reassign to silence:
#: ``wrappers.CONSTRUCTOR_VERBOSITY = NonlinearVerbosity("none")``.
CONSTRUCTOR_VERBOSITY = _NV("standard")


def CMINPACK(*, method=None, autodiff=None, **ignored):
    """MINPACK bridge (extension_algs.jl; ext/NonlinearSolveMINPACKExt.jl).

    Mapping: ``hybr``/``hybrd`` (Powell hybrid = dogleg trust region) →
    ``TrustRegion()``; ``lm``/``lmdif`` → ``LevenbergMarquardt()``;
    ``auto`` → ``TrustRegion()`` (MINPACK's hybr default; LM is selected
    for NLLS problems by the solve-level default polyalgorithm anyway).
    """
    _warn_dropped("CMINPACK", ignored, autodiff=autodiff)
    from .first_order import LevenbergMarquardt, TrustRegion
    m = _sym(method, "auto")
    if m in ("lm", "lmdif"):
        return LevenbergMarquardt()
    return TrustRegion()


def NLsolveJL(*, method=None, linesearch=None, m=10, beta=1.0, **ignored):
    """NLsolve.jl bridge.  ``trust_region`` → ``TrustRegion`` with the
    NLsolve radius-update scheme; ``newton`` → ``NewtonRaphson`` (with the
    requested line search); ``anderson`` → ``AndersonAcceleration(m, beta)``;
    ``broyden`` → ``Broyden``."""
    _warn_dropped("NLsolveJL", ignored)
    from .anderson import AndersonAcceleration
    from .first_order import NewtonRaphson, TrustRegion
    from .quasi_newton import Broyden
    meth = _sym(method, "trust_region")
    if meth == "newton":
        return NewtonRaphson(linesearch=linesearch)
    if meth == "anderson":
        return AndersonAcceleration(m=int(m), beta=float(beta))
    if meth == "broyden":
        return Broyden()
    return TrustRegion(radius_update_scheme="nlsolve")


def NLSolversJL(method=None, **ignored):
    """NLSolvers.jl bridge.  The reference passes an NLSolvers method
    object; here a string preset: ``newton`` → ``NewtonRaphson``;
    ``newton_hagerzhang``/``newton_backtracking``/``newton_strongwolfe``/
    ``newton_morethuente`` → Newton with that line search."""
    _warn_dropped("NLSolversJL", ignored)
    from ..core.linesearch import BackTracking
    from ..core.wolfe_linesearch import (HagerZhang, MoreThuente,
                                         StrongWolfe)
    from .first_order import NewtonRaphson
    meth = _sym(method, "newton")
    presets = {"newton": None,
               "newton_backtracking": BackTracking(),
               "newton_hagerzhang": HagerZhang(),
               "newton_strongwolfe": StrongWolfe(),
               "newton_morethuente": MoreThuente()}
    if meth not in presets:
        raise ValueError(f"unknown NLSolversJL method {method!r}; "
                         f"expected one of {sorted(presets)}")
    return NewtonRaphson(linesearch=presets[meth])


def SIAMFANLEquationsJL(*, method=None, delta=1e-3, m=0, beta=1.0,
                        **ignored):
    """SIAMFANLEquations.jl bridge: ``newton`` → ``NewtonRaphson``;
    ``pseudotransient`` → ``PseudoTransient(alpha_initial=delta)``;
    ``secant``/``broyden`` → ``Broyden``; ``anderson`` →
    ``AndersonAcceleration(m, beta)``."""
    _warn_dropped("SIAMFANLEquationsJL", ignored)
    from .anderson import AndersonAcceleration
    from .first_order import NewtonRaphson, PseudoTransient
    from .quasi_newton import Broyden
    meth = _sym(method, "newton")
    if meth == "pseudotransient":
        return PseudoTransient(alpha_initial=float(delta))
    if meth in ("secant", "broyden"):
        return Broyden()
    if meth == "anderson":
        return AndersonAcceleration(m=max(int(m), 1), beta=float(beta))
    return NewtonRaphson()


def LeastSquaresOptimJL(alg=None, *, linsolve=None, autodiff=None,
                        **ignored):
    """LeastSquaresOptim.jl bridge: ``lm`` → ``LevenbergMarquardt``;
    ``dogleg`` → ``TrustRegion`` (dogleg descent)."""
    _warn_dropped("LeastSquaresOptimJL", ignored,
                  linsolve=linsolve, autodiff=autodiff)
    from .first_order import LevenbergMarquardt, TrustRegion
    if _sym(alg, "lm") == "dogleg":
        return TrustRegion()
    return LevenbergMarquardt()


def FastLevenbergMarquardtJL(linsolve=None, **kwargs):
    """FastLevenbergMarquardt.jl bridge → ``LevenbergMarquardt`` with the
    reference's damping factors when given."""
    from .first_order import LevenbergMarquardt
    lm_kwargs = {}
    if "factor" in kwargs:
        lm_kwargs["damping_initial"] = float(kwargs.pop("factor"))
    _warn_dropped("FastLevenbergMarquardtJL", kwargs,
                  linsolve=linsolve)
    return LevenbergMarquardt(**lm_kwargs)


def SpeedMappingJL(**ignored):
    """SpeedMapping.jl bridge (ACX extrapolation of fixed-point maps) →
    ``AndersonAcceleration`` (the native accelerated-fixed-point role)."""
    _warn_dropped("SpeedMappingJL", ignored)
    from .anderson import AndersonAcceleration
    return AndersonAcceleration()


def FixedPointAccelerationJL(*, algorithm=None, m=None, **ignored):
    """FixedPointAcceleration.jl bridge: ``Anderson`` →
    ``AndersonAcceleration(m)``; ``Newton`` → ``NewtonRaphson``; the
    epsilon-extrapolation variants (``Aitken``/``VEA``/``SEA``/``Simple``)
    → ``AndersonAcceleration`` with a short window (their natural
    Anderson-equivalent depth)."""
    _warn_dropped("FixedPointAccelerationJL", ignored)
    from .anderson import AndersonAcceleration
    from .first_order import NewtonRaphson
    algo = _sym(algorithm, "anderson")
    if algo == "newton":
        return NewtonRaphson()
    if algo in ("aitken", "vea", "sea", "simple"):
        return AndersonAcceleration(m=2 if m is None else int(m))
    return AndersonAcceleration(m=5 if m is None else int(m))


def PETScSNES(*, petsclib=None, autodiff=None, mpi_comm=None,
              **snes_options):
    """PETSc SNES bridge.  ``snes_type`` maps to the native engine:
    ``newtonls`` (SNES default: Newton + cubic backtracking) →
    ``NewtonRaphson(linesearch=BackTracking())``; ``newtontr`` →
    ``TrustRegion``; ``anderson``/``ngmres`` → ``AndersonAcceleration``;
    ``qn`` → ``Broyden``; ``ksponly`` → plain ``NewtonRaphson``.

    PETSc's MPI distribution role (``mpi_comm``) belongs to
    ``parallel.distributed_solve``; the constructor drops
    it with the notice.
    """
    snes_type = _sym(snes_options.pop("snes_type", None), "newtonls")
    _warn_dropped("PETScSNES", snes_options, petsclib=petsclib,
                  autodiff=autodiff, mpi_comm=mpi_comm)
    from ..core.linesearch import BackTracking
    from .anderson import AndersonAcceleration
    from .first_order import NewtonRaphson, TrustRegion
    from .quasi_newton import Broyden
    if snes_type == "newtontr":
        return TrustRegion()
    if snes_type in ("anderson", "ngmres"):
        return AndersonAcceleration()
    if snes_type == "qn":
        return Broyden()
    if snes_type == "ksponly":
        return NewtonRaphson()
    return NewtonRaphson(linesearch=BackTracking())


def KINSOL(*, linear_solver=None, globalization_strategy=None,
           strategy=None, m=0, **ignored):
    """Sundials KINSOL bridge (ext/NonlinearSolveSundialsExt.jl):
    ``none`` → ``NewtonRaphson``; ``linesearch`` →
    ``NewtonRaphson(linesearch=BackTracking())``; ``fixedpoint``/
    ``picard`` → ``AndersonAcceleration(m)`` (KINSOL's Anderson-accelerated
    fixed-point mode)."""
    _warn_dropped("KINSOL", ignored, linear_solver=linear_solver)
    from ..core.linesearch import BackTracking
    from .anderson import AndersonAcceleration
    from .first_order import NewtonRaphson
    strat = _sym(globalization_strategy if globalization_strategy is not None
                 else strategy, "none")
    if strat == "linesearch":
        return NewtonRaphson(linesearch=BackTracking())
    if strat in ("fixedpoint", "picard"):
        return AndersonAcceleration(m=max(int(m), 1))
    return NewtonRaphson()

WRAPPER_ALGS = (SciPyRoot, SciPyRootScalar, SciPyLeastSquares)


def is_wrapper_alg(alg) -> bool:
    return isinstance(alg, WRAPPER_ALGS)


def construct_extension_function_wrapper(prob):
    """The ``f(x: ndarray) -> ndarray`` shape external solvers expect, and
    a dense Jacobian callback: ``(x0, unravel, f_np, jac_np)``, on the flat
    state of ``ravel_pytree(u0)``.  Both callbacks evaluate on ``u0``'s
    device; ``unravel`` gives a host vector back as ``u0``'s tree."""
    from ..core.autodiff import jacfwd
    from ..core.solve import state_device
    from ..utils.pytree import ravel_pytree
    u0_flat, unravel_u = ravel_pytree(prob.u0,
                                      device=state_device(prob.u0, prob.p))
    dtype, dev = u0_flat.dtype, u0_flat.device
    p, f = prob.p, prob.f

    def unravel(x):
        return unravel_u(torch.as_tensor(np.asarray(x), dtype=dtype,
                                         device=dev).reshape(-1))

    def f_flat(v):
        return ravel_pytree(f(unravel_u(v), p), device=dev)[0]

    def to_flat(x):
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=dev).reshape(-1)

    def f_np(x):
        with torch.no_grad():
            return _backend.to_host(f_flat(to_flat(x)))

    def jac_np(x):
        with torch.no_grad():
            return _backend.to_host(jacfwd(f_flat)(to_flat(x)))

    return _backend.to_host(u0_flat), unravel, f_np, jac_np


def _interval_device(prob):
    """The device and dtype of an interval problem's tensors (the card and
    float64 when there are none), as the bracketing tier takes them."""
    tensors = [x for x in (*prob.tspan, prob.p)
               if isinstance(x, torch.Tensor)]
    dev = (tensors[0].device if tensors else _backend.resolve_device(None))
    dtype = torch.float64
    ends = [x for x in prob.tspan if isinstance(x, torch.Tensor)]
    if ends:
        dtype = torch.promote_types(ends[0].dtype, torch.float32)
    return dev, dtype


def solve_wrapper(prob, alg, *, abstol=None, maxiters=1000, **_ignored
                  ) -> NonlinearSolution:
    """Solve with a SciPy bridge."""
    from scipy import optimize

    if isinstance(alg, SciPyRootScalar):
        from ..core.problems import IntervalNonlinearProblem
        if not isinstance(prob, IntervalNonlinearProblem):
            raise TypeError(
                "SciPyRootScalar needs an IntervalNonlinearProblem")
        dev, dtype = _interval_device(prob)

        def fn(x):
            with torch.no_grad():
                val = prob.f(torch.tensor(x, dtype=dtype, device=dev),
                             prob.p)
            return float(_backend.to_host(val))

        res = optimize.root_scalar(
            fn, bracket=tuple(float(t) for t in prob.tspan),
            method=alg.method)
        return NonlinearSolution(
            u=torch.tensor(res.root, dtype=dtype, device=dev),
            resid=torch.tensor(fn(res.root), dtype=dtype, device=dev),
            retcode=(ReturnCode.Success if res.converged
                     else ReturnCode.Failure),
            stats=NLStats(nf=int(getattr(res, "function_calls", 0))))

    from ..core.solve import state_device
    u0, unravel, f_np, jac_np = construct_extension_function_wrapper(prob)
    if isinstance(alg, SciPyLeastSquares):
        res = optimize.least_squares(f_np, u0, jac=jac_np, method=alg.method,
                                     loss=alg.loss, max_nfev=maxiters)
        u, resid, nf = res.x, res.fun, res.nfev
    else:
        use_jac = alg.method in ("hybr", "lm")
        res = optimize.root(f_np, u0, jac=jac_np if use_jac else None,
                            method=alg.method, tol=abstol)
        u, resid = res.x, np.atleast_1d(res.fun)
        nf = getattr(res, "nfev", 0)
    return NonlinearSolution(
        u=unravel(u), resid=torch.as_tensor(
            np.asarray(resid, dtype=u0.dtype),
            device=state_device(prob.u0, prob.p)),
        retcode=ReturnCode.Success if res.success else ReturnCode.Failure,
        stats=NLStats(nf=int(nf)), original=res)

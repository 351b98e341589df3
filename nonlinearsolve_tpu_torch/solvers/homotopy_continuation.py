"""All-roots solving for polynomial, rational and transformed systems (the
port of ``solvers/homotopy_continuation.py``): a
``HomotopyNonlinearFunction`` carries ``polynomialize`` /
``unpolynomialize`` / ``denominator`` transforms around a
polynomial-space residual, driven by the lockstep total-degree path
tracker (``solvers/poly_homotopy.py``).

* ``HomotopyContinuationJL`` — the residual *is* polynomial; per-equation
  degrees are taken from ``degrees`` or measured exactly along a random ray
  (finite differences of a polynomial terminate).  All Bézout paths are
  tracked in one batch.
* ``TaylorHomotopyContinuationJL`` — smooth residuals: a degree-``degree``
  Taylor surrogate (nested ``torch.func.jacfwd``), its roots tracked, every
  candidate polished against the true residual (``solve_multistart``).

Both drop roots where ``denominator`` vanishes, map the survivors through
``unpolynomialize``, and return all distinct real roots (``all_roots=True``)
or the root closest to ``u0``.  Paths are tracked in the complex dtype of
``u0``'s (complex128 for f64); the JAX package's refusal without x64 has no
counterpart here, the dtype being the caller's.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import _backend
from ..core.problems import NonlinearFunction, NonlinearProblem, _wrap_function
from ..core.returncode import ReturnCode
from ..core.solution import NLStats, NonlinearSolution


def _identity_polynomialize(u, p):
    return u


def _identity_unpolynomialize(u, p):
    return [u]


def _unit_denominator(u, p):
    return torch.ones((), dtype=u.dtype if isinstance(u, torch.Tensor)
                      else torch.float64)


@dataclasses.dataclass(frozen=True, eq=True)
class HomotopyNonlinearFunction:
    """How a (possibly rational or transformed) system maps to polynomial
    space.

    - ``f``: the polynomial-space residual (a ``NonlinearFunction``).
    - ``polynomialize(u, p)``: user space → polynomial space.
    - ``unpolynomialize(v, p)``: polynomial root → list of user-space
      preimages (may be several, e.g. for ``u = exp(v)`` branches).
    - ``denominator(v, p)``: denominators of a rational system; roots where
      any entry is ~0 are spurious and dropped.
    """

    f: NonlinearFunction
    polynomialize: Callable = _identity_polynomialize
    unpolynomialize: Callable = _identity_unpolynomialize
    denominator: Callable = _unit_denominator

    def __post_init__(self):
        object.__setattr__(self, "f", _wrap_function(self.f))

    def __call__(self, u, p=None):
        return self.f(u, p)

    def __hash__(self):
        return hash((self.f, self.polynomialize, self.unpolynomialize,
                     self.denominator))


@dataclasses.dataclass(frozen=True, eq=True)
class HomotopyContinuationJL:
    """All-roots polynomial solve.  ``degrees``: per-equation total
    degrees; measured along a random ray when omitted (the residual must
    then be exactly polynomial of total degree ≤ 8 per equation)."""

    all_roots: bool = False
    degrees: Optional[Sequence[int]] = None
    denominator_abstol: float = 1e-7
    gamma_seed: int = 0
    name: str = "HomotopyContinuationJL"

    def __post_init__(self):
        if self.degrees is not None:
            object.__setattr__(self, "degrees",
                               tuple(int(d) for d in self.degrees))


@dataclasses.dataclass(frozen=True, eq=True)
class TaylorHomotopyContinuationJL:
    """Smooth-residual variant: Taylor-surrogate tracking + Newton
    polish."""

    all_roots: bool = False
    degree: int = 2
    denominator_abstol: float = 1e-7
    name: str = "TaylorHomotopyContinuationJL"


def measure_polynomial_degrees(f_np: Callable, n: int, max_degree: int = 8,
                               seed: int = 0, rtol: float = 1e-7
                               ) -> tuple:
    """Exact per-equation total degree of a polynomial residual, measured by
    finite differences along a random ray: for ``g(t) = f(a + t·b)`` the
    (d+1)-th forward difference of a degree-d polynomial is identically 0.
    Host-side float64; degrees ≤ ``max_degree``."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n) * 0.37
    b = rng.standard_normal(n)
    b /= np.linalg.norm(b)
    ts = np.arange(max_degree + 2, dtype=np.float64)
    samples = np.stack([np.atleast_1d(np.asarray(f_np(a + t * b),
                                                 np.float64)) for t in ts])
    m = samples.shape[1]
    degrees = []
    for i in range(m):
        col = samples[:, i]
        scale = max(np.max(np.abs(col)), 1.0)
        diffs = col.copy()
        deg = 0
        for k in range(1, max_degree + 2):
            diffs = np.diff(diffs)
            if np.max(np.abs(diffs)) > rtol * scale * (2.0 ** k):
                deg = k
        if deg >= max_degree + 1:
            raise ValueError(
                f"equation {i}: residual is not polynomial of degree ≤ "
                f"{max_degree} along a random ray; pass degrees= explicitly "
                "or use TaylorHomotopyContinuationJL")
        degrees.append(max(deg, 1))
    return tuple(degrees)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return _backend.to_host(x)
    return np.asarray(x)


def _filter_and_unpolynomialize(hf: HomotopyNonlinearFunction, roots_poly,
                                p, denominator_abstol, dedupe_tol=1e-8,
                                device=None):
    """Denominator filter, unpolynomialize and user-space dedupe; the
    user's maps see each root as a float64 tensor on ``device``."""
    valid = []
    for r in np.atleast_2d(np.asarray(roots_poly)):
        r_t = torch.as_tensor(r, device=device)
        den = np.atleast_1d(_host(hf.denominator(r_t, p)))
        if np.any(np.abs(den) <= denominator_abstol):
            continue
        for sol in hf.unpolynomialize(r_t, p):
            s = np.atleast_1d(_host(sol))
            if np.any(np.isnan(s)):
                continue
            if not any(np.max(np.abs(s - q))
                       <= dedupe_tol * (1 + np.max(np.abs(q)))
                       for q in valid):
                valid.append(s)
    return valid


def solve_homotopy_continuation(prob, alg, *, abstol=None, maxiters=100,
                                **_ignored) -> NonlinearSolution:
    """``solve`` for ``HomotopyContinuationJL`` /
    ``TaylorHomotopyContinuationJL``."""
    from ..core.solve import state_tensor
    from .multistart import solve_multistart
    from .poly_homotopy import PolynomialHomotopy, solve_polynomial

    inner = prob.f.f if isinstance(prob.f, NonlinearFunction) else prob.f
    hf = inner if isinstance(inner, HomotopyNonlinearFunction) else \
        HomotopyNonlinearFunction(f=prob.f)
    p = prob.p
    u0_in = state_tensor(prob.u0, p)
    u0 = torch.atleast_1d(u0_in)
    dev = u0.device
    scalar_input = u0_in.dim() == 0
    u0_poly = torch.atleast_1d(state_tensor(hf.polynomialize(u0_in, p),
                                            device=dev))
    n = u0_poly.numel()
    f_poly = hf.f.f

    def f_vec(u, p_):
        return torch.atleast_1d(torch.as_tensor(
            f_poly(u[0] if scalar_input and u.shape == (1,) else u, p_)))

    poly_prob = NonlinearProblem(f_vec, u0_poly, p)

    if isinstance(alg, HomotopyContinuationJL):
        degrees = alg.degrees
        if degrees is None:
            def f_np(x):
                with torch.no_grad():
                    return _backend.to_host(f_vec(torch.as_tensor(
                        x, dtype=torch.float64, device=dev), p))
            degrees = measure_polynomial_degrees(f_np, n, seed=alg.gamma_seed)
        sol = solve_polynomial(
            poly_prob, PolynomialHomotopy(degrees=tuple(degrees),
                                          gamma_seed=alg.gamma_seed),
            all_roots=True, real_only=True)
        roots_poly = (np.atleast_2d(_backend.to_host(sol.u).astype(
            np.float64)) if sol.u.numel() else np.zeros((0, n)))
        stats = sol.stats
    else:
        roots = solve_multistart(poly_prob, order=int(alg.degree),
                                 maxiters=maxiters)
        roots_poly = (np.atleast_2d(_backend.to_host(roots).astype(
            np.float64)) if roots.numel() else np.zeros((0, n)))
        stats = NLStats(nsteps=len(roots_poly))

    valid = _filter_and_unpolynomialize(hf, roots_poly, p,
                                        alg.denominator_abstol, device=dev)
    dtype = u0.dtype

    def _resid_user(u_user):
        return torch.as_tensor(f_poly(hf.polynomialize(u_user, p), p))

    if not valid:
        retcode = (ReturnCode.ConvergenceFailure if len(roots_poly) == 0
                   else ReturnCode.Infeasible)
        return NonlinearSolution(
            u=u0_in, resid=_resid_user(u0_in), retcode=retcode,
            stats=stats, original=roots_poly)

    valid_arr = torch.as_tensor(np.stack(valid), dtype=dtype, device=dev)
    if scalar_input and valid_arr.shape[-1] == 1:
        valid_arr = valid_arr[..., 0]

    if alg.all_roots:
        resids = torch.func.vmap(
            lambda v: _resid_user(v).abs().amax())(valid_arr)
        return NonlinearSolution(
            u=valid_arr, resid=resids, retcode=ReturnCode.Success,
            stats=stats, original=roots_poly)

    flat = np.atleast_2d(_backend.to_host(valid_arr).astype(
        np.float64).reshape(len(valid), -1))
    ref = _backend.to_host(u0).astype(np.float64).reshape(-1)
    best = int(np.argmin(np.max(np.abs(flat - ref[None]), axis=1)))
    u_best = valid_arr[best]
    return NonlinearSolution(
        u=u_best, resid=_resid_user(u_best), retcode=ReturnCode.Success,
        stats=stats, original=roots_poly)

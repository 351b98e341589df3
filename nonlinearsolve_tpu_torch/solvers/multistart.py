"""Taylor polynomialization and multistart root finding (the port of
``solvers/multistart.py``).

1. ``polynomialize`` — the degree-``order`` Taylor model of ``f(·, p)`` at
   ``u0`` from nested ``torch.func.jacfwd`` derivative tensors (einsum
   contractions, exact AD, no symbolic algebra).
2. ``solve_multistart`` — all roots of the Taylor model by the
   total-degree polynomial homotopy (``solve_polynomial``), then every real
   candidate polished against the true residual and the distinct converged
   roots returned.

The polish solves each candidate on its own (``solve_ensemble`` over the
starts, which runs NewtonRaphson trajectory by trajectory: each row is its
lone solve, as under the JAX package's ``vmap``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import _backend


def polynomialize(f, u0, p, order: int = 3):
    """Return ``(poly_f, degrees)``: the Taylor model of ``f(·, p)`` at
    ``u0`` to total degree ``order`` (1 ≤ order ≤ 4) as a polynomial
    callable ``poly_f(u, p_ignored)``, plus per-equation degrees."""
    if not 1 <= order <= 4:
        raise ValueError("polynomialize supports 1 <= order <= 4")
    u0 = torch.as_tensor(u0)
    n = u0.numel()

    def f_fixed(u):
        return torch.atleast_1d(torch.as_tensor(f(u, p)))

    with torch.no_grad():
        f0 = f_fixed(u0)
        tensors = []
        deriv = f_fixed
        for _ in range(order):
            deriv = torch.func.jacfwd(deriv)
            tensors.append(deriv(u0))

    letters = "abcdefgh"

    def poly_f(u, _p=None):
        u = torch.as_tensor(u)
        d = u - u0.to(u.dtype)
        out = f0.to(d.dtype)
        for k, T in enumerate(tensors, start=1):
            spec = "z" + letters[:k] + "," + ",".join(letters[:k]) + "->z"
            term = torch.einsum(spec, T.to(d.dtype), *([d] * k))
            out = out + term / math.factorial(k)
        return out

    return poly_f, (order,) * n


def solve_multistart(prob, *, order: int = 3, polish_alg=None,
                     real_tol: float = 1e-6, dedupe_tol: float = 1e-6,
                     resid_tol: Optional[float] = None, maxiters: int = 100):
    """Find the distinct real roots of ``prob`` near ``prob.u0``.

    Returns an ``(n_roots, n)`` tensor of converged, deduplicated roots of
    the true residual (possibly empty), on ``u0``'s device.  ``order``
    controls the Taylor model degree (Bézout count = order**n paths — keep
    ``n·order`` small); ``polish_alg`` defaults to NewtonRaphson.
    """
    from ..core.ensemble import solve_ensemble
    from ..core.problems import NonlinearProblem
    from ..core.solve import state_tensor
    from .first_order import NewtonRaphson
    from .poly_homotopy import PolynomialHomotopy, solve_polynomial

    u0 = torch.atleast_1d(state_tensor(prob.u0, prob.p))
    n, dtype, dev = u0.numel(), u0.dtype, u0.device
    f = prob.f.f

    poly_f, degrees = polynomialize(f, u0, prob.p, order)
    poly_sol = solve_polynomial(
        NonlinearProblem(poly_f, u0, None), PolynomialHomotopy(
            degrees=degrees), all_roots=True, real_only=True,
        imag_tol=real_tol, dedupe_tol=dedupe_tol)
    starts = np.atleast_2d(_backend.to_host(poly_sol.u).astype(np.float64))
    if starts.size == 0:
        return torch.zeros((0, n), dtype=dtype, device=dev)

    alg = polish_alg if polish_alg is not None else NewtonRaphson()
    starts_t = torch.as_tensor(starts, dtype=dtype, device=dev)
    sols = solve_ensemble(NonlinearProblem(f, starts_t[0], prob.p), alg,
                          u0s=starts_t, maxiters=maxiters)
    roots = _backend.to_host(sols.u)
    resids = _backend.to_host(sols.resid)
    good = np.max(np.abs(resids), axis=-1) < (
        resid_tol if resid_tol is not None
        else 1e3 * np.sqrt(np.finfo(roots.dtype).eps))

    uniq = []
    for r, ok in zip(roots, good):
        if not ok or not np.all(np.isfinite(r)):
            continue
        if not any(np.linalg.norm(r - q) < dedupe_tol * (1 + np.linalg.norm(q))
                   for q in uniq):
            uniq.append(r)
    if not uniq:
        return torch.zeros((0, n), dtype=dtype, device=dev)
    return torch.as_tensor(np.stack(uniq), dtype=dtype, device=dev)

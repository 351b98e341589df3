"""Matrix-free restarted GMRES (the port of ``ops/krylov.py``'s ``gmres``).

Left-preconditioned GMRES(m) with classical Gram–Schmidt, a second pass
(CGS2) only when the Rutishauser test sees cancellation, Givens rotations
and restarts.  The iterate keeps its shape (no flattening of the caller's
layout); the basis is an (m+1, n) buffer whose rows are views of that
shape.

The big vectors stay on the device.  The small ones — the Hessenberg
column, the rotations, the rotated right-hand side ``g`` — live on the host
as numpy scalars of the working dtype, so their arithmetic rounds as the
JAX package's does on the device, and the data-dependent loop tests are
plain Python.  Each test reads the device once (``_backend.fetch``): one
host sync per Arnoldi iteration, one more when the re-orthogonalisation
runs, one per restart and one at the start.  The JAX version's chunked
basis prefixes (a ``lax.switch`` to bound HBM reads on the TPU) become
slices ``V[:k+1]``; sums are taken in another order, which the tests'
tolerances allow for.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._backend import fetch, np_dtype


class KrylovResult(NamedTuple):
    x: torch.Tensor
    residual_norm: float
    iterations: int
    success: bool


def _identity_precond(x):
    return x


def _back_substitute(R: np.ndarray, g: np.ndarray) -> np.ndarray:
    """Solve the upper-triangular ``R y = g`` in R's dtype."""
    k = g.shape[0]
    y = np.zeros(k, R.dtype)
    for i in range(k - 1, -1, -1):
        y[i] = (g[i] - R[i, i + 1:k] @ y[i + 1:k]) / R[i, i]
    return y


def gmres(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
          *, restart: int = 20, maxiter: Optional[int] = None, rtol=1e-5,
          atol=0.0, M: Optional[Callable] = None,
          basis_dtype=None) -> KrylovResult:
    """Restarted GMRES(m), left-preconditioned: solves M⁻¹A x = M⁻¹b.

    ``rtol``/``atol`` may be Python numbers or numpy scalars (e.g. the
    Eisenstat–Walker forcing term in the working dtype).

    ``basis_dtype`` (e.g. ``torch.bfloat16``) stores the Krylov basis V in
    a narrower dtype, as the JAX package's: each vector is rounded on store
    and upcast on read (one upcast copy of the occupied prefix per Arnoldi
    iteration, shared by both Gram–Schmidt passes); the Hessenberg and
    Givens recurrences, the norms and the dot accumulations stay in the
    working dtype.  It pairs with loose inner tolerances (Eisenstat–Walker
    inexact Newton), not rtol ≲ 1e-4."""
    if basis_dtype is not None and b.is_complex():
        raise ValueError("basis_dtype narrowing stores a REAL basis; "
                         "complex systems must keep the working dtype")
    if b.is_complex():
        raise NotImplementedError("complex GMRES is ROADMAP A.33")
    n = b.numel()
    shape = b.shape
    dtype = b.dtype
    npdt = np_dtype(dtype)
    m = min(restart, n)
    if maxiter is None:
        maxiter = min(10 * max(1, n // m), 1000) * m
    M = M or _identity_precond

    def l2(x):
        return torch.linalg.vector_norm(x)

    x0_is_zero = x0 is None
    x = torch.zeros_like(b) if x0 is None else x0
    mb = M(b)
    r = mb if x0_is_zero else M(b - matvec(x))
    if x0_is_zero:
        b_norm, = fetch(l2(mb))
        rnorm = b_norm
    else:
        b_norm, rnorm = fetch(l2(mb), l2(r))
    tol = np.maximum(npdt(rtol) * b_norm, npdt(atol))
    V = torch.empty((m + 1, n), dtype=basis_dtype or dtype, device=b.device)
    beta = rnorm           # the norm of r, known for the first cycle
    it = 0
    while rnorm > tol and it < maxiter:
        # --- one Arnoldi cycle (r is the preconditioned residual) ---
        safe_beta = npdt(1) if beta == 0 else beta
        V[0] = (r * (npdt(1) / safe_beta)).reshape(-1)
        H = np.zeros((m + 1, m), npdt)
        cs = np.zeros(m, npdt)
        sn = np.zeros(m, npdt)
        g = np.zeros(m + 1, npdt)
        g[0] = beta
        k = 0
        done = beta <= tol
        while k < m and not done:
            w = M(matvec(V[k].view(shape).to(dtype))).reshape(-1)
            Vk = V[: k + 1].to(dtype)
            hd = Vk @ w
            w_norm0 = l2(w)
            w = w - hd @ Vk
            wn = l2(w)
            h_host, w_norm0, h_next = fetch(hd, w_norm0, wn)
            h = np.zeros(m + 1, npdt)
            h[: k + 1] = h_host
            if h_next < npdt(0.7071) * w_norm0:
                hd2 = Vk @ w
                w = w - hd2 @ Vk
                h2_host, h_next = fetch(hd2, l2(w))
                h[: k + 1] += h2_host
            happy = h_next <= npdt(1e-14) * np.abs(g[0])
            scale = (npdt(0) if happy
                     else npdt(1) / (npdt(1) if h_next == 0 else h_next))
            V[k + 1] = w * scale
            h[k + 1] = npdt(0) if happy else h_next
            for i in range(k):      # previous Givens rotations
                hi = cs[i] * h[i] + sn[i] * h[i + 1]
                hi1 = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i], h[i + 1] = hi, hi1
            denom = np.sqrt(h[k] ** 2 + h[k + 1] ** 2)
            safe = npdt(1) if denom == 0 else denom
            ck = npdt(1) if denom == 0 else h[k] / safe
            sk = npdt(0) if denom == 0 else h[k + 1] / safe
            cs[k], sn[k] = ck, sk
            h[k] = ck * h[k] + sk * h[k + 1]
            h[k + 1] = 0
            gk1 = -sk * g[k]
            g[k + 1] = gk1
            g[k] = ck * g[k]
            H[:, k] = h
            done = bool(np.abs(gk1) <= tol) or bool(happy)
            k += 1
        # upper-triangular solve on the first k columns (zero diagonals
        # replaced by 1, as the JAX version guards them)
        R = H[:k, :k].copy()
        diag = np.diagonal(R).copy()
        R[np.arange(k), np.arange(k)] = np.where(diag == 0, npdt(1), diag)
        y = _back_substitute(R, g[:k])
        if k:
            x = x + (torch.as_tensor(y, device=b.device)
                     @ V[:k].to(dtype)).view(shape)
        rnorm = np.abs(g[k])
        it += k
        if rnorm > tol:
            # the restart residual is only needed if another cycle runs
            r = M(b - matvec(x))
            beta, = fetch(l2(r))
    finite, = fetch(torch.isfinite(x).all())
    return KrylovResult(x=x, residual_norm=rnorm, iterations=it,
                        success=bool(rnorm <= tol) and bool(finite))


def solve_krylov(method: str, matvec, b, x0=None, **kw) -> KrylovResult:
    if method == "gmres":
        return gmres(matvec, b, x0, **kw)
    if method in ("bicgstab", "cg", "minres"):
        raise NotImplementedError(
            f"Krylov method {method!r} is ROADMAP A.33")
    raise ValueError(f"unknown Krylov method {method!r}")

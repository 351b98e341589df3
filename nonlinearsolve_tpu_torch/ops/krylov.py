"""Matrix-free Krylov solvers (the port of ``ops/krylov.py``): restarted
GMRES, BiCGStab, CG and MINRES.

GMRES:

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

BiCGStab, CG and MINRES keep their short recurrences' scalars on the device
as 0-d tensors (the JAX package's ``while_loop`` carry, op for op) and read
the device once an iteration: the loop test (the residual norm and, where
the JAX loop has one, its breakdown flag) in one ``fetch``.  Iteration
counts, the stopping rule and ``success`` are the JAX package's.

Complex systems: GMRES orthogonalises with the conjugated inner product
Σ conj(vᵢ)wᵢ and eliminates with complex Givens rotations [c̄ s̄; −s c]
(the JAX package's loop takes the unconjugated Σ vᵢwᵢ and real rotation
formulas there, and stalls: ROADMAP C); BiCGStab's ρ, α and ω are
complex; CG and MINRES keep the JAX package's real inner product
Re Σ conj(aᵢ)bᵢ, which is exact for the Hermitian systems they solve.
Norms and tolerances are real.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .._backend import fetch, np_dtype, real_np_dtype
from ..utils.norms import l2_norm, tree_dot


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
    n = b.numel()
    dtype = b.dtype
    cplx = b.is_complex()
    npdt = np_dtype(dtype)              # H, the rotations and g
    rdt = real_np_dtype(dtype)          # norms and tolerances
    m = min(restart, n)
    if maxiter is None:
        maxiter = min(10 * max(1, n // m), 1000) * m
    M = M or _identity_precond

    def l2(x):
        return torch.linalg.vector_norm(x)

    x0_is_zero = x0 is None
    x = torch.zeros_like(b) if x0 is None else x0
    flat = _Flat(b)
    mb = M(b)
    r = mb if x0_is_zero else M(b - matvec(x))
    if x0_is_zero:
        b_norm, = fetch(l2(mb))
        rnorm = b_norm
    else:
        b_norm, rnorm = fetch(l2(mb), l2(r))
    tol = np.maximum(rdt(rtol) * b_norm, rdt(atol))
    V = flat.basis(m + 1, basis_dtype or dtype)
    beta = rnorm           # the norm of r, known for the first cycle
    it = 0
    while rnorm > tol and it < maxiter:
        # --- one Arnoldi cycle (r is the preconditioned residual) ---
        safe_beta = rdt(1) if beta == 0 else beta
        V[0] = flat.flat(r * (rdt(1) / safe_beta))
        H = np.zeros((m + 1, m), npdt)
        cs = np.zeros(m, npdt)
        sn = np.zeros(m, npdt)
        g = np.zeros(m + 1, npdt)
        g[0] = beta
        k = 0
        done = beta <= tol
        while k < m and not done:
            w = flat.flat(M(matvec(flat.shaped(V[k].to(dtype)))))
            Vk = V[: k + 1].to(dtype)
            VkH = Vk.conj() if cplx else Vk
            hd = flat.sum(VkH @ w)
            w_norm0 = flat.norm(w)
            w = w - hd @ Vk
            wn = flat.norm(w)
            h_host, w_norm0, h_next = fetch(hd, w_norm0, wn)
            h = np.zeros(m + 1, npdt)
            h[: k + 1] = h_host
            if h_next < rdt(0.7071) * w_norm0:
                hd2 = flat.sum(VkH @ w)
                w = w - hd2 @ Vk
                h2_host, h_next = fetch(hd2, flat.norm(w))
                h[: k + 1] += h2_host
            happy = h_next <= rdt(1e-14) * np.abs(g[0])
            scale = (rdt(0) if happy
                     else rdt(1) / (rdt(1) if h_next == 0 else h_next))
            V[k + 1] = w * scale
            h[k + 1] = npdt(0) if happy else h_next
            # previous Givens rotations (complex: [c̄ s̄; -s c], the
            # conjugates being the identity on real scalars)
            for i in range(k):
                hi = np.conj(cs[i]) * h[i] + np.conj(sn[i]) * h[i + 1]
                hi1 = -sn[i] * h[i] + cs[i] * h[i + 1]
                h[i], h[i + 1] = hi, hi1
            if cplx:
                denom = np.sqrt(np.abs(h[k]) ** 2 + np.abs(h[k + 1]) ** 2)
            else:
                denom = np.sqrt(h[k] ** 2 + h[k + 1] ** 2)
            safe = npdt(1) if denom == 0 else denom
            ck = npdt(1) if denom == 0 else h[k] / safe
            sk = npdt(0) if denom == 0 else h[k + 1] / safe
            cs[k], sn[k] = ck, sk
            h[k] = np.conj(ck) * h[k] + np.conj(sk) * h[k + 1]
            h[k + 1] = 0
            gk1 = -sk * g[k]
            g[k + 1] = gk1
            g[k] = np.conj(ck) * g[k]
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
            x = x + flat.shaped(torch.as_tensor(y, device=flat.device)
                                @ V[:k].to(dtype))
        rnorm = np.abs(g[k])
        it += k
        if rnorm > tol:
            # the restart residual is only needed if another cycle runs
            r = M(b - matvec(x))
            beta, = fetch(l2(r))
    finite, = fetch(torch.isfinite(x).all())
    return KrylovResult(x=x, residual_norm=rnorm, iterations=it,
                        success=bool(rnorm <= tol) and bool(finite))


class _Flat:
    """GMRES's view of the state as one vector of its n entries.  A plain
    tensor is flattened (``reshape(-1)``) and its basis is (rows, n).  A
    DTensor is kept as this rank's shard: the basis holds the local
    shard's entries, flattened, as a plain (rows, n_local) tensor, a dot
    product or a norm is the local one summed over the mesh dimensions
    that shard the state (``all_reduce``, as DTensor sums its partial
    results), and ``shaped`` puts a local vector back in the state's
    placements.  So no DTensor is ever flattened: torch 2.11's DTensor
    refuses to flatten a state sharded past its first dimension
    (``distributed_solve``'s ``shard_axis=1``)."""

    def __init__(self, b):
        from torch.distributed.tensor import DTensor
        self.shape = b.shape
        self.dtensor = isinstance(b, DTensor)
        self.device = (b.to_local() if self.dtensor else b).device
        if not self.dtensor:
            return
        self.mesh, self.placements = b.device_mesh, tuple(b.placements)
        self.local_shape = b.to_local().shape
        self.stride = b.stride()
        self.groups = [self.mesh.get_group(i)
                       for i, p in enumerate(self.placements)
                       if p.is_shard() and self.mesh.size(i) > 1]

    def basis(self, rows: int, dtype) -> torch.Tensor:
        n = self.local_shape.numel() if self.dtensor else self.shape.numel()
        return torch.empty((rows, n), dtype=dtype, device=self.device)

    def flat(self, t: torch.Tensor) -> torch.Tensor:
        if not self.dtensor:
            return t.reshape(-1)
        if tuple(t.placements) != self.placements:
            t = t.redistribute(self.mesh, self.placements)
        return t.to_local().reshape(-1)

    def shaped(self, v: torch.Tensor) -> torch.Tensor:
        if not self.dtensor:
            return v.view(self.shape)
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(v.view(self.local_shape), self.mesh,
                                  self.placements, run_check=False,
                                  shape=self.shape, stride=self.stride)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The local partial sums ``t`` summed over the shards."""
        if self.dtensor:
            import torch.distributed as dist
            for group in self.groups:
                dist.all_reduce(t, group=group)
        return t

    def norm(self, w: torch.Tensor) -> torch.Tensor:
        """‖w‖₂ of a flat vector: over the shards, the local norms' squares
        summed, then the square root, as DTensor reduces a norm."""
        local = torch.linalg.vector_norm(w)
        if not (self.dtensor and self.groups):
            return local
        return self.sum(local ** 2) ** 0.5


def _short_setup(b, x0, maxiter, rtol, atol, M):
    """What BiCGStab, CG and MINRES share: ``(maxiter, M, x0, the numpy
    scalar type of b's real dtype)``, with maxiter 2n and x0 zero by
    default."""
    npdt = real_np_dtype(b.dtype)
    if maxiter is None:
        maxiter = 2 * b.numel()
    return (maxiter, M or _identity_precond,
            torch.zeros_like(b) if x0 is None else x0, npdt)


def _cdot(a, b):
    """Σ conj(aᵢ)bᵢ, a complex 0-d tensor."""
    return torch.sum(a.conj() * b)


def _safe(t):
    """``where(t == 0, 1, t)`` on a 0-d tensor."""
    return torch.where(t == 0, torch.ones_like(t), t)


def _result(x, rnorm, tol, it):
    finite, = fetch(torch.isfinite(x).all())
    return KrylovResult(x=x, residual_norm=rnorm, iterations=it,
                        success=bool(rnorm <= tol) and bool(finite))


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, *,
             maxiter: Optional[int] = None, rtol=1e-5, atol=0.0,
             M: Optional[Callable] = None) -> KrylovResult:
    """Preconditioned BiCGStab (van der Vorst), the JAX package's loop:
    it stops when ‖r‖ ≤ tol, after ``maxiter`` iterations, or on a
    breakdown (a non-finite residual, ρ = 0 or r̂·v = 0).  On a complex
    system ρ, α and ω are complex, from the inner products Σ conj(aᵢ)bᵢ
    (the JAX package's loop keeps them real there, and fails to trace)."""
    maxiter, M, x, npdt = _short_setup(b, x0, maxiter, rtol, atol, M)
    dot = _cdot if b.is_complex() else tree_dot
    r = b - matvec(x)
    rhat = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho = alpha = omega = one
    b_norm, rnorm = fetch(l2_norm(b), l2_norm(r))
    tol = np.maximum(npdt(rtol) * b_norm, npdt(atol))
    it, ok = 0, True
    while rnorm > tol and it < maxiter and ok:
        rho_new = dot(rhat, r)
        beta = (rho_new / _safe(rho)) * (alpha / _safe(omega))
        p = r + beta * (p + (-omega) * v)
        phat = M(p)
        v = matvec(phat)
        denom = dot(rhat, v)
        alpha = rho_new / _safe(denom)
        s = r + (-alpha) * v
        shat = M(s)
        t = matvec(shat)
        omega = dot(t, s) / _safe(dot(t, t))
        x = (x + omega * shat) + alpha * phat
        r = s + (-omega) * t
        rho = rho_new
        rn = l2_norm(r)
        rnorm, ok = fetch(rn, torch.isfinite(rn) & (rho_new != 0)
                          & (denom != 0))
        it += 1
    return _result(x, rnorm, tol, it)


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       *, maxiter: Optional[int] = None, rtol=1e-5, atol=0.0,
       M: Optional[Callable] = None) -> KrylovResult:
    """Preconditioned conjugate gradients (SPD systems), the JAX package's
    loop: it stops when ‖r‖ ≤ tol or after ``maxiter`` iterations."""
    maxiter, M, x, npdt = _short_setup(b, x0, maxiter, rtol, atol, M)
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = tree_dot(r, z)
    b_norm, rnorm = fetch(l2_norm(b), l2_norm(r))
    tol = np.maximum(npdt(rtol) * b_norm, npdt(atol))
    it = 0
    while rnorm > tol and it < maxiter:
        Ap = matvec(p)
        alpha = rz / _safe(tree_dot(p, Ap))
        x = x + alpha * p
        r = r + (-alpha) * Ap
        z = M(r)
        rz_new = tree_dot(r, z)
        p = z + (rz_new / _safe(rz)) * p
        rz = rz_new
        rnorm, = fetch(l2_norm(r))
        it += 1
    return _result(x, rnorm, tol, it)


def minres(matvec: Callable, b: torch.Tensor,
           x0: Optional[torch.Tensor] = None, *,
           maxiter: Optional[int] = None, rtol=1e-5, atol=0.0,
           M: Optional[Callable] = None) -> KrylovResult:
    """MINRES (Paige–Saunders) for symmetric, possibly indefinite systems;
    ``M`` must be SPD when given.  The JAX package's loop: it stops when the
    recurrence's residual estimate is ≤ tol, after ``maxiter`` iterations or
    on a breakdown (γ = 0, a non-finite estimate); ``residual_norm`` is the
    true ‖b − A x‖ (one more product), and ``success`` holds it to 10·tol."""
    maxiter, M, x, npdt = _short_setup(b, x0, maxiter, rtol, atol, M)
    r0 = b - matvec(x)
    y0 = M(r0)
    beta0 = torch.sqrt(torch.clamp(tree_dot(r0, y0), min=0.0))
    safe_b0 = _safe(beta0)
    v, y = (1.0 / safe_b0) * r0, (1.0 / safe_b0) * y0
    v_old, w, w_old = (torch.zeros_like(b) for _ in range(3))
    zero = torch.zeros((), dtype=beta0.dtype, device=b.device)
    beta, eta = zero, beta0
    c0, c1, s0, s1 = zero + 1.0, zero + 1.0, zero, zero
    b_norm, r_norm = fetch(l2_norm(b), beta0)
    tol = np.maximum(npdt(rtol) * b_norm, npdt(atol))
    it, ok = 0, True
    while r_norm > tol and it < maxiter and ok:
        Av = matvec(y)
        alpha = tree_dot(y, Av)
        v_new = Av - alpha * v - beta * v_old
        y_new = M(v_new)
        beta_new = torch.sqrt(torch.clamp(tree_dot(v_new, y_new), min=0.0))
        safe_bn = _safe(beta_new)
        # the previous rotations on the new tridiagonal column
        delta = c0 * alpha - c1 * s0 * beta
        rho2 = s1 * beta
        rho3 = s0 * alpha + c1 * c0 * beta
        # the new rotation annihilating beta_new
        gamma = torch.sqrt(delta ** 2 + beta_new ** 2)
        safe_g = _safe(gamma)
        cs, sn = delta / safe_g, beta_new / safe_g
        w, w_old = (y - rho3 * w - rho2 * w_old) / safe_g, w
        x = x + (cs * eta) * w
        rn = torch.abs(sn * eta)
        eta = -sn * eta
        v, v_old = (1.0 / safe_bn) * v_new, v
        y = (1.0 / safe_bn) * y_new
        beta = beta_new
        c0, c1, s0, s1 = cs, c0, sn, s0
        r_norm, ok = fetch(rn, torch.isfinite(rn) & (gamma != 0))
        it += 1
    true_r, = fetch(l2_norm(b - matvec(x)))
    return _result(x, true_r, np.maximum(tol, npdt(10) * tol), it)


def solve_krylov(method: str, matvec, b, x0=None, **kw) -> KrylovResult:
    if method == "gmres":
        return gmres(matvec, b, x0, **kw)
    solver = {"bicgstab": bicgstab, "cg": cg, "minres": minres}.get(method)
    if solver is None:
        raise ValueError(f"unknown Krylov method {method!r}")
    kw.pop("restart", None)
    return solver(matvec, b, x0, **kw)

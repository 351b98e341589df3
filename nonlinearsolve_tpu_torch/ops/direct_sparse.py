"""Sparse direct solvers (the port of ``ops/direct_sparse.py``).

The reference reaches KLU/UMFPACK for sparse direct Newton steps.  The JAX
package keeps the structured cases on the device, log-depth and vectorised,
and sends the rest to a host LU; the port does the same:

* ``tridiagonal_solve_pcr`` — parallel cyclic reduction: ⌈log₂ n⌉ sweeps of
  shifted elementwise operations;
* ``block_tridiagonal_solve_pcr`` — block cyclic reduction: the same
  recurrence on b×b blocks, each sweep a batch of (m, b, b) solves and
  products.  A banded matrix with bandwidths (kl, ku) is reblocked to
  block-tridiagonal form with ``b = max(kl, ku)``;
* ``_rcm_banded_solve`` — a general pattern that reverse Cuthill–McKee
  makes banded enough goes to block cyclic reduction after the reorder;
* ``_host_sparse_lu_solve`` — everything else: the AMD ordering and the
  native Gilbert–Peierls LU of ``csrc/sparsetools.cpp`` on the host, one
  persistent factor a pattern (``_FACTORS``: numeric-only refactorization
  on later Newton steps).  The JAX package's ``pure_callback`` is a plain
  host call here: J's data and the right-hand side go to the host in one
  copy, x comes back in one;
* ``_iterative_sparse_solve`` — above ``_HOST_LU_MAX_N`` unknowns, BiCGStab
  with a Jacobi preconditioner on J's own SpMV tier, with the host LU kept
  for when it fails.  The JAX package's ``lax.cond`` on BiCGStab's flag is
  a host decision on its ``success``.

``solve_sparse_direct`` routes a CSR or DIA system: tridiagonal → PCR;
banded (bandwidth ≤ ``_BCR_MAX_BW``) → block cyclic reduction, directly or
after RCM; otherwise the host LU (BiCGStab first above ``_HOST_LU_MAX_N``);
the dense LU only below ``_DENSE_CROSSOVER`` unknowns or when AMD refuses
the pattern.  A failed native build raises: where the JAX package drops to
the dense LU because its library is missing, the port does not.
``_backend.ROUTES`` counts the routes taken.
"""

from __future__ import annotations

import functools
import math
import threading
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np
import torch

from .. import _backend
from .sparse import CSR, DIA

_BCR_MAX_BW = 64
_DENSE_CROSSOVER = 64        # below this, the dense LU
# Above this row count the host factorization and the round trip lose to a
# preconditioned Krylov solve on the device (the JAX package's crossover).
_HOST_LU_MAX_N = 50_000


def _shift_down(v, k):
    """``v[i - k]`` along dim 0, zero-filled (``jnp.roll`` then a set)."""
    if k >= v.shape[0]:
        return torch.zeros_like(v)
    return torch.cat([v.new_zeros((k,) + v.shape[1:]), v[:v.shape[0] - k]])


def _shift_up(v, k):
    """``v[i + k]`` along dim 0, zero-filled."""
    if k >= v.shape[0]:
        return torch.zeros_like(v)
    return torch.cat([v[k:], v.new_zeros((k,) + v.shape[1:])])


def tridiagonal_solve_pcr(dl, d, du, b):
    """Solve a tridiagonal system by parallel cyclic reduction.

    ``dl`` (n,) subdiagonal (``dl[0]`` ignored), ``d`` (n,) diagonal, ``du``
    (n,) superdiagonal (``du[n-1]`` ignored), ``b`` (n,).  ⌈log₂ n⌉ sweeps,
    each O(n) elementwise work."""
    n = d.shape[0]
    a = torch.cat([dl.new_zeros(1), dl[1:]])
    c = torch.cat([du[:n - 1], du.new_zeros(1)])
    x = b
    ones = torch.ones_like(d)
    zeros = torch.zeros_like(d)
    steps = max(1, math.ceil(math.log2(max(n, 2))))
    k = 1
    for _ in range(steps):
        d_down, d_up = _shift_down(d, k), _shift_up(d, k)
        safe_down = torch.where(d_down == 0, ones, d_down)
        safe_up = torch.where(d_up == 0, ones, d_up)
        alpha = torch.where(_shift_down(ones, k) > 0, -a / safe_down, zeros)
        gamma = torch.where(_shift_up(ones, k) > 0, -c / safe_up, zeros)
        a_new = alpha * _shift_down(a, k)
        c_new = gamma * _shift_up(c, k)
        d_new = d + alpha * _shift_down(c, k) + gamma * _shift_up(a, k)
        x_new = x + alpha * _shift_down(x, k) + gamma * _shift_up(x, k)
        a, c, d, x = a_new, c_new, d_new, x_new
        k *= 2
    return x / torch.where(d == 0, ones, d)


def dia_tridiagonal_parts(A: DIA):
    """``(dl, d, du)`` of a DIA matrix with offsets ⊆ {-1, 0, 1}: each is
    the stored diagonal itself (``data[d, i] = A[i, i + off]``)."""
    zero = torch.zeros(A.shape[0], dtype=A.data.dtype, device=A.data.device)
    parts = {off: zero for off in (-1, 0, 1)}
    for i, off in enumerate(A.offsets):
        if off in parts:
            parts[off] = A.data[i]
    return parts[-1], parts[0], parts[1]


def is_tridiagonal(A) -> bool:
    if isinstance(A, DIA):
        return all(off in (-1, 0, 1) for off in A.offsets)
    if isinstance(A, CSR):
        from ..native import bandwidths
        kl, ku = bandwidths(A.indptr, A.indices, A.shape[0])
        return kl <= 1 and ku <= 1
    return False


def _solve_batched(A, B):
    """``A⁻¹ B`` for a batch, without the error check (no host sync); a
    singular block gives non-finite values, as ``jnp.linalg.solve``."""
    return torch.linalg.solve_ex(A, B, check_errors=False).result


def block_tridiagonal_solve_pcr(L, D, U, y):
    """Solve a block-tridiagonal system by block cyclic reduction.

    ``L, D, U`` (m, b, b): the sub, diagonal and super blocks (``L[0]`` and
    ``U[m-1]`` ignored); ``y`` (m, b).  ⌈log₂ m⌉ sweeps, each a batch of
    b×b solves and products over every block row.  The reduced diagonal
    blocks must stay nonsingular (diagonally dominant Jacobians do)."""
    m, b, _ = D.shape
    eye = torch.eye(b, dtype=D.dtype, device=D.device).expand(m, b, b)
    L = torch.cat([L.new_zeros((1, b, b)), L[1:]])
    U = torch.cat([U[:m - 1], U.new_zeros((1, b, b))])

    def shift_down_eye(X, k):      # X[i - k], identity-filled
        return torch.cat([eye[:k], X[:m - k]])

    def shift_up_eye(X, k):        # X[i + k], identity-filled
        return torch.cat([X[k:], eye[:k]])

    steps = max(1, math.ceil(math.log2(max(m, 2))))
    k = 1
    for _ in range(steps):
        kk = min(k, m)
        Dd, Du = shift_down_eye(D, kk), shift_up_eye(D, kk)
        # alpha = -L inv(Dd), computed as -solve(Ddᵀ, Lᵀ)ᵀ (batched)
        alpha = -_solve_batched(Dd.mT, L.mT).mT
        gamma = -_solve_batched(Du.mT, U.mT).mT
        L_new = torch.bmm(alpha, _shift_down(L, kk))
        U_new = torch.bmm(gamma, _shift_up(U, kk))
        D_new = (D + torch.bmm(alpha, _shift_down(U, kk))
                 + torch.bmm(gamma, _shift_up(L, kk)))
        y_new = (y + torch.bmm(alpha, _shift_down(y, kk)[..., None])[..., 0]
                 + torch.bmm(gamma, _shift_up(y, kk)[..., None])[..., 0])
        L, U, D, y = L_new, U_new, D_new, y_new
        k *= 2
    return _solve_batched(D, y[..., None])[..., 0]


@functools.lru_cache(maxsize=64)
def _block_tables(offsets: tuple, n: int, b: int, device: torch.device):
    """The plumbing of ``dia_to_block_tridiag``, once a pattern and device:
    for each in-band slot of the DIA data (flat index ``d·n + i``) its place
    in the flat (3, m, b, b) block table, the pad rows' diagonal places,
    and m."""
    m = -(-n // b)
    r = np.arange(n)
    src, dst = [], []
    for d, off in enumerate(offsets):
        if abs(off) > b:
            raise ValueError(f"offset {off} exceeds block size {b}")
        c = r + off
        valid = (c >= 0) & (c < n)
        rv, cv = r[valid], c[valid]
        I, q = rv // b, rv % b
        J, p = cv // b, cv % b
        delta = (J - I) + 1          # ∈ {0, 1, 2}
        src.append(d * n + rv)
        dst.append(((delta * m + I) * b + q) * b + p)
    rpad = np.arange(n, m * b)
    pad = ((m + rpad // b) * b + rpad % b) * b + rpad % b
    return tuple(torch.as_tensor(a.astype(np.int64), device=device)
                 for a in (np.concatenate(src), np.concatenate(dst),
                           pad)) + (m,)


def dia_to_block_tridiag(A: DIA, b: int):
    """Reblock a banded DIA matrix (every |offset| ≤ b) into ``(L, D, U,
    m)`` block-tridiagonal form with b×b blocks (the index plumbing is
    host numpy, once a pattern)."""
    n = A.shape[0]
    src, dst, pad, m = _block_tables(A.offsets, n, b, A.data.device)
    T = torch.zeros(3 * m * b * b, dtype=A.data.dtype, device=A.data.device)
    T[dst] = A.data.reshape(-1)[src]
    # identity rows for the zero padding [n, m·b) keep D nonsingular
    T[pad] = 1.0
    T = T.reshape(3, m, b, b)
    return T[0], T[1], T[2], m


def bandwidth_of(A) -> Optional[Tuple[int, int]]:
    """``(kl, ku)`` of a CSR or DIA matrix, else ``None``."""
    if isinstance(A, DIA):
        return (max((-o for o in A.offsets if o < 0), default=0),
                max((o for o in A.offsets if o > 0), default=0))
    if isinstance(A, CSR):
        from ..native import bandwidths
        kl, ku = bandwidths(A.indptr, A.indices, A.shape[0])
        return int(kl), int(ku)
    return None


def _banded(A, rhs):
    """``banded_solve`` without the route count: ``(x, ok, route)``."""
    if isinstance(A, CSR):
        A = DIA.from_csr(A)
    if is_tridiagonal(A):
        x = tridiagonal_solve_pcr(*dia_tridiagonal_parts(A), rhs)
        return x, torch.isfinite(x).all(), "pcr"
    kl, ku = bandwidth_of(A)
    b = max(kl, ku, 1)
    L, D, U, m = dia_to_block_tridiag(A, b)
    n = A.shape[0]
    ypad = torch.zeros(m * b, dtype=rhs.dtype, device=rhs.device)
    ypad[:n] = rhs
    x = block_tridiagonal_solve_pcr(L, D, U, ypad.reshape(m, b))
    x = x.reshape(-1)[:n]
    return x, torch.isfinite(x).all(), "bcr"


def banded_solve(A, rhs):
    """Direct banded solve: PCR for tridiagonal, block cyclic reduction
    otherwise.  ``A`` is DIA (or CSR, converted).  Returns ``(x, ok)``
    with ``ok`` a 0-d device bool (x finite)."""
    x, ok, route = _banded(A, rhs)
    _backend.count_route(route)
    return x, ok


class _RcmPlan:
    """RCM order of a pattern, its banded offsets and the scatter of J's
    data into the permuted DIA layout (host arrays; device copies by
    device)."""

    def __init__(self, perm, pinv, offsets, src, dst):
        self.perm, self.pinv, self.offsets = perm, pinv, offsets
        self.src, self.dst = src, dst
        self._tables: dict = {}

    def tables(self, device):
        if device not in self._tables:
            self._tables[device] = tuple(
                torch.as_tensor(a, device=device)
                for a in (self.perm, self.pinv, self.src, self.dst))
        return self._tables[device]


@functools.lru_cache(maxsize=64)
def _rcm_band_plan(indptr_bytes, indices_bytes, n):
    """Host symbolic pass: RCM-order a general CSR pattern and check that
    the permuted pattern is banded enough for block cyclic reduction (the
    fill-reducing role AMD plays inside KLU).  The plan, or ``None``."""
    from ..native import rcm_ordering
    indptr = np.frombuffer(indptr_bytes, np.int32)
    indices = np.frombuffer(indices_bytes, np.int32)
    try:
        perm = rcm_ordering(indptr, indices, n)
    except ValueError:               # the library refused the pattern
        return None
    pinv = np.empty(n, np.int64)
    pinv[perm] = np.arange(n)
    row_ids = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    new_r = pinv[row_ids]
    offs = pinv[indices.astype(np.int64)] - new_r
    kl, ku = int(max(-offs.min(), 0)), int(max(offs.max(), 0))
    if max(kl, ku) == 0 or max(kl, ku) > _BCR_MAX_BW or n <= 4 * max(kl, ku):
        return None
    uniq, which = np.unique(offs, return_inverse=True)
    # entry k of the CSR data lands at (diagonal which[k], permuted row)
    dst = which.reshape(-1).astype(np.int64) * n + new_r
    return _RcmPlan(perm.astype(np.int64), pinv,
                    tuple(int(o) for o in uniq),
                    np.arange(len(indices), dtype=np.int64), dst)


def _rcm_banded_solve(A: CSR, b):
    plan = _rcm_band_plan(A.indptr.tobytes(), A.indices.tobytes(),
                          A.shape[0])
    if plan is None:
        return None
    n = A.shape[0]
    perm, pinv, src, dst = plan.tables(A.data.device)
    data = torch.zeros(len(plan.offsets) * n, dtype=A.data.dtype,
                       device=A.data.device)
    data[dst] = A.data[src]
    B = DIA(data.reshape(len(plan.offsets), n), plan.offsets, (n, n))
    _backend.count_route("rcm_bcr")
    z, ok, _route = _banded(B, b[perm])
    return z[pinv], ok


# ---------------------------------------------------------------------------
# the general host sparse LU (the KLU role proper)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def _amd_plan(indptr_bytes, indices_bytes, n):
    """Host symbolic pass: the AMD ordering's bytes, or ``None`` when the
    library refuses the pattern.  Cached on the static pattern."""
    from ..native import amd_ordering
    perm = amd_ordering(np.frombuffer(indptr_bytes, np.int32),
                        np.frombuffer(indices_bytes, np.int32), n)
    return None if perm is None else perm.tobytes()


def sparse_lu_fill(A: CSR, *, ordering: str = "amd") -> Optional[int]:
    """nnz(L) + nnz(U) of the native LU under ``ordering`` ('amd', 'rcm' or
    'natural') — the fill-in diagnostic (host only)."""
    from ..native import amd_ordering, rcm_ordering, sp_lu_solve
    n = A.shape[0]
    perm = None
    if ordering == "amd":
        perm = amd_ordering(A.indptr, A.indices, n)
    elif ordering == "rcm":
        perm = rcm_ordering(A.indptr, A.indices, n)
    data = _backend.to_host(A.data.double())
    return sp_lu_solve(A.indptr, A.indices, data, np.zeros(n), perm)[1]


class _FactorCache:
    """Bounded, pattern-keyed cache of persistent native LU factors: the
    symbolic analysis and the pivot order come with a pattern's first
    factorization, later Newton steps refactor numerically only (the
    reference's ``reuse_A_if_factorization``).  A factor is freed when it
    is evicted.  The lock keeps the table consistent for callers on other
    threads; ``factorize_solve`` holds the factor's own lock."""

    def __init__(self, maxsize=32):
        self.maxsize = maxsize
        self._d = OrderedDict()
        self._lock = threading.Lock()

    def get(self, A: CSR):
        key = (A.indptr.tobytes(), A.indices.tobytes(), A.shape[0])
        with self._lock:
            fac = self._d.get(key)
            if fac is not None:
                self._d.move_to_end(key)
                return fac
        plan = _amd_plan(*key)
        if plan is None:
            return None
        from ..native import SpLuFactor
        fac = SpLuFactor(A.indptr, A.indices, A.shape[0],
                         perm=np.frombuffer(plan, np.int32))
        with self._lock:
            hit = self._d.get(key)
            if hit is not None:          # raced: keep the first one
                return hit
            self._d[key] = fac
            if len(self._d) > self.maxsize:
                _, old = self._d.popitem(last=False)
                old.close()
        return fac


_FACTORS = _FactorCache()


def _host_sparse_lu_solve(A: CSR, b):
    """The persistent native host LU: J's data and b go to the host in one
    copy, the factor is (re)made and applied there, x comes back in one.
    ``None`` when AMD refuses the pattern."""
    n = A.shape[0]
    fac = _FACTORS.get(A)
    if fac is None:
        return None
    _backend.count_route("host_lu")
    dtype = torch.promote_types(A.data.dtype, b.dtype)
    host = _backend.to_host(torch.cat([A.data.double(), b.double()]))
    x = fac.factorize_solve(host[:A.nnz], host[A.nnz:])
    if x is None or not np.all(np.isfinite(x)):
        x = np.full(n, np.nan)
    x = torch.as_tensor(x, device=b.device).to(dtype)
    return x, torch.isfinite(x).all()


def _iterative_sparse_solve(A: CSR, b):
    """Jacobi-preconditioned BiCGStab on J's own SpMV tier (staged once:
    K4 on the "dia" tier).  Returns ``(x, success)`` with ``success`` a
    host bool."""
    from .krylov import bicgstab
    d = A.diagonal()
    dinv = torch.where(torch.abs(d) > 0, 1.0 / d, torch.ones_like(d))
    # rtol above the working dtype's floor: at f32 a fixed 1e-8 would spend
    # the whole budget every Newton step before the host LU took over
    eps = torch.finfo(torch.promote_types(A.data.dtype, b.dtype)).eps
    rtol = max(1e-8, float(50.0 * eps))
    maxiter = min(4 * A.shape[0], 20_000 if eps < 1e-10 else 2_000)
    _backend.count_route("iterative")
    res = bicgstab(A.matvec_fn(), b, maxiter=maxiter, rtol=rtol,
                   M=lambda x: dinv * x)
    return res.x, res.success


def solve_sparse_direct(A, b):
    """Direct solve of a sparse system (see the module docstring for the
    routes).  Returns ``(x, ok)`` with ``ok`` a 0-d device bool."""
    from .linear_solve import solve_dense

    if isinstance(A, CSR) and is_tridiagonal(A):
        A = DIA.from_csr(A)
    if isinstance(A, DIA) and is_tridiagonal(A):
        return banded_solve(A, b)
    bw = bandwidth_of(A)
    if bw is not None and 0 < max(bw) <= _BCR_MAX_BW \
            and A.shape[0] > 4 * max(bw):
        return banded_solve(A, b)
    if isinstance(A, CSR) and A.shape[0] > 16:
        out = _rcm_banded_solve(A, b)
        if out is not None:
            return out
    if isinstance(A, CSR) and A.shape[0] >= _DENSE_CROSSOVER:
        if A.shape[0] > _HOST_LU_MAX_N:
            # BiCGStab on the device first; the exact host LU only when it
            # fails (the JAX package's lax.cond, decided on the host here)
            x_it, ok_it = _iterative_sparse_solve(A, b)
            if ok_it:
                return x_it, torch.isfinite(x_it).all()
            out = _host_sparse_lu_solve(A, b)
            if out is None:                  # AMD refused the pattern
                return x_it, torch.zeros((), dtype=torch.bool,
                                         device=b.device)
            return out
        out = _host_sparse_lu_solve(A, b)
        if out is not None:
            return out
    _backend.count_route("dense")
    dense = A.todense() if isinstance(A, (CSR, DIA)) else A
    return solve_dense(dense, b)

"""Dense linear solves (the port of ``ops/linear_solve.py``): the
``LinearSolver`` config, ``solve_dense`` with every dense method, the
Gauss–Jordan small-system path, the rank-deficient ridge fallback,
``solve_spd`` and the SVD least squares.

A singular or non-SPD system gives non-finite values, never an exception:
the factorizations are the ``_ex`` variants with ``check_errors=False``,
whose ``info`` turns into NaN on the device (no host read).

The rank-deficient fallback (the JAX package's ``lax.cond`` on
finiteness) needs a decision that depends on device values.
``solve_dense`` takes it with one host read.  Inside
``deferred_fallbacks()`` it reads nothing: it returns the primary result
(non-finite, ``ok = False``, for a singular system) and appends the device
flag "the fallback was wanted" to the context's list; the caller reads
the flags with its own read and, when one is set, runs the computation
again outside the context (where each decision is read;
``recorded_fallbacks()`` keeps those outcomes).  The first-order engine
steps that way, so a step whose linear solves need no fallback costs no
read of its own.  The contexts are per thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Optional

import torch

from .._backend import fetch


@dataclasses.dataclass(frozen=True)
class LinearSolver:
    """Static linear-solver selection.

    method: 'auto' | 'lu' | 'qr' | 'cholesky' | 'svd' | 'diagonal'
            | 'gmres' | 'bicgstab' | 'cg' | 'minres' | 'sparse_lu_device'.
    The dense methods run through ``solve_dense``; of the Krylov methods
    the port runs 'gmres' (the others raise where they are used).
    ``precond_fn(u) -> (v -> M⁻¹v)`` is rebuilt at each Newton step; a
    plain ``v -> M⁻¹v`` callable is accepted too.
    ``krylov_basis_dtype`` ('bf16', 'bfloat16' or 'f16') stores the GMRES
    basis in that dtype (``ops.krylov.gmres(basis_dtype=)``).
    """

    method: str = "auto"
    restart: int = 20
    krylov_maxiter: Optional[int] = None
    precond: str = "none"
    precond_fn: Any = None
    krylov_basis_dtype: Optional[str] = None

    @property
    def is_krylov(self) -> bool:
        return self.method in ("gmres", "bicgstab", "cg", "minres")


# ---------------------------------------------------------------------------
# deferred fallback decisions
# ---------------------------------------------------------------------------

_LOCAL = threading.local()     # .stack: (mode, list) pairs, innermost last


def _stack() -> list:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = []
    return _LOCAL.stack


@contextlib.contextmanager
def deferred_fallbacks():
    """Within the block, ``solve_dense`` and ``solve_spd`` read nothing to
    decide their fallbacks: each appends a 0-d device bool (True where the
    fallback was wanted) to the yielded list and returns its primary
    result."""
    flags: list = []
    _stack().append(("defer", flags))
    try:
        yield flags
    finally:
        _stack().pop()


@contextlib.contextmanager
def recorded_fallbacks():
    """Within the block, each fallback decision is read as it comes (as
    outside any block) and its outcome, a host bool, is appended to the
    yielded list."""
    outcomes: list = []
    _stack().append(("record", outcomes))
    try:
        yield outcomes
    finally:
        _stack().pop()


def _decide(wanted: torch.Tensor) -> bool:
    """True when the fallback must run now; False when it is not wanted or
    the decision is deferred (the flag then goes to the context's list)."""
    stack = _stack()
    mode, seen = stack[-1] if stack else (None, None)
    if mode == "defer":
        seen.append(wanted)
        return False
    out = bool(fetch(wanted)[0])
    if mode == "record":
        seen.append(out)
    return out


def _all_finite(*ts) -> torch.Tensor:
    out = torch.isfinite(ts[0]).all()
    for t in ts[1:]:
        out = out & torch.isfinite(t).all()
    return out


def _nan_unless(x: torch.Tensor, good: torch.Tensor) -> torch.Tensor:
    return torch.where(good, x, torch.full_like(x, float("nan")))


# ---------------------------------------------------------------------------
# the dense methods
# ---------------------------------------------------------------------------

def _lstsq(A: torch.Tensor, b: torch.Tensor, factors=None, matvec=None):
    """Least squares by the SVD, ``jnp.linalg.lstsq(A, b, rcond=None)``
    step for step: singular values below ``eps · max(m, n) · s_max`` are
    dropped, so rank-deficient systems get the minimum-norm solution.
    ``A`` may carry leading batch dimensions (``b`` then carries them too),
    each matrix solved on its own: the finite guard and the cutoff are per
    matrix.  ``factors``: the ``(U, S, Vh)`` of ``A`` from an earlier call,
    to solve another right-hand side without a second SVD (the same result
    as recomputing it).  ``matvec(M, v)``: the product of a batch of
    matrices with a batch of vectors ``b`` (``core.lockstep.rows_matvec``,
    which rounds each row as a lone solve does); batched ``@`` when
    omitted.  Returns ``(x, factors)``."""
    m, n = A.shape[-2:]
    vec = b.dim() == A.dim() - 1
    B = b[..., None] if vec else b
    if factors is None:
        # torch's SVD raises on non-finite input (the JAX one returns NaN):
        # it factors zeros there and sets the factors to NaN
        finite = torch.isfinite(A).all(dim=-1, keepdim=True).all(
            dim=-2, keepdim=True)
        U, S, Vh = torch.linalg.svd(torch.where(finite, A, 0.0),
                                    full_matrices=False)
        factors = (_nan_unless(U, finite), _nan_unless(S, finite[..., 0]),
                   _nan_unless(Vh, finite))
    U, S, Vh = factors
    rcond = float(torch.finfo(A.real.dtype).eps) * max(n, m)
    mask = (S > 0) & (S >= torch.tensor(rcond, dtype=S.dtype,
                                        device=S.device) * S[..., :1])
    safe_s = torch.where(mask, S, torch.ones_like(S)).to(A.dtype)
    s_inv = torch.where(mask, 1 / safe_s, torch.zeros_like(safe_s))[..., None]
    if matvec is not None and vec:
        return matvec(Vh.mH, s_inv[..., 0] * matvec(U.mH, b)), factors
    uTb = U.mH @ B
    x = Vh.mH @ (s_inv * uTb)
    return (x[..., 0] if vec else x), factors


# Gauss–Jordan for n ≤ 32, as the JAX package's ``_square_solve`` does
# (there it beats the TPU's batched LU; here it keeps the rounding of small
# systems equal to the JAX package's).
_GJ_MAX_N = 32


def gauss_jordan_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Square solve by Gauss–Jordan elimination with partial pivoting in
    one-hot row algebra (no dynamic row slices), rounding as the JAX
    package's does step for step: exactly singular systems produce
    non-finite entries (division by a zero pivot).  ``b`` may be a vector
    (n,) or a block (n, k).

    The JAX package's row swap ``M + ek·(row_p - row_k) + ep·(row_k -
    row_p)`` and its pivot-row insert are written here as fused
    multiply-adds: with one-hot ``ek`` / ``ep`` each product is exact, so
    the sums round as the JAX ones; the elimination ``M - factors·prow`` is
    one too, as XLA contracts it."""
    n = A.shape[-1]
    vec = b.dim() == 1
    B = b[..., None] if vec else b
    M = torch.cat([A, B], dim=-1)                         # (n, n+k)
    if M.device.type == "cpu" and M.dtype in (torch.float32, torch.float64):
        # the same arithmetic in one host call (csrc/densetools.cpp)
        from ..native import gauss_jordan
        M = gauss_jordan(M.contiguous())
        return M[:, n] if vec else M[:, n:]
    if M.device.type == "cuda":
        return _gauss_jordan_graph(M, n, vec)
    return _gauss_jordan_ops(M, n, vec)


# (shape, dtype, device, vector right-hand side) -> (CUDA graph, its input,
# its output); a vector and a one-column block give M the same shape, and
# their outputs differ in shape
_GJ_GRAPHS: dict = {}


def _gauss_jordan_graph(M: torch.Tensor, n: int, vec: bool) -> torch.Tensor:
    """The tensor-operation route on the card, captured once per shape in
    a CUDA graph (about 14 small kernels an elimination step, launched by
    one replay) and replayed on a copy of ``M``."""
    key = (tuple(M.shape), M.dtype, M.device, vec)
    entry = _GJ_GRAPHS.get(key)
    if entry is None:
        static_in = M.clone()
        stream = torch.cuda.current_stream(M.device)
        side = torch.cuda.Stream(M.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):
            _gauss_jordan_ops(static_in, n, vec)          # warm-up
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = _gauss_jordan_ops(static_in, n, vec)
        entry = _GJ_GRAPHS[key] = (graph, static_in, static_out)
    graph, static_in, static_out = entry
    static_in.copy_(M)
    graph.replay()
    return static_out.clone()


def _gauss_jordan_ops(M: torch.Tensor, n: int, vec: bool) -> torch.Tensor:
    """``gauss_jordan_solve`` in tensor operations (the card's route; no
    host read, so it can be captured in a CUDA graph).  ``M`` may carry
    leading batch dimensions; each matrix is eliminated on its own, with
    the same one-hot row algebra, so a row of a batch rounds as it does
    alone.  A complex ``M`` pivots on the modulus, as ``jnp.abs`` does.
    It is the CPU's route for complex systems too."""
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    off = 1.0 - eye                                       # rows: 1 - ek
    idx = torch.arange(n, device=M.device)
    below = torch.ones(n, n, dtype=torch.bool, device=M.device).tril()
    neg_inf = torch.full((n,), float("-inf"), dtype=M.real.dtype,
                         device=M.device)
    for k in range(n):
        ek = eye[k][:, None]
        cand = torch.where(below[:, k], M[..., :, k].abs(), neg_inf)
        piv = torch.argmax(cand, dim=-1, keepdim=True)
        ep = (idx == piv).to(M.dtype)[..., :, None]
        row_k = eye[k] @ M
        row_p = (ep.transpose(-1, -2) @ M)[..., 0, :]
        d = (row_p - row_k)[..., None, :]
        M = torch.addcmul(torch.addcmul(M, ek, d), ep, d, value=-1.0)
        prow = (row_p / row_p[..., k:k + 1])[..., None, :]
        M = torch.addcmul(M * off[k][:, None], ek, prow)
        factors = M[..., :, k] * off[k]
        M = torch.addcmul(M, factors[..., :, None], prow, value=-1.0)
    return M[..., :, n] if vec else M[..., :, n:]


def _lu_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LU (getrf/getrs; cuSOLVER on the card) with no error check: a zero
    pivot gives NaN."""
    x, info = torch.linalg.solve_ex(A, b, check_errors=False)
    return _nan_unless(x, info == 0)


def _square_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """LU for large systems, Gauss–Jordan for small ones."""
    if A.shape[-1] <= _GJ_MAX_N:
        return gauss_jordan_solve(A, b)
    return _lu_solve(A, b)


def _cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``cho_factor`` / ``cho_solve`` on the lower triangle; a matrix that
    is not positive definite gives NaN (as the JAX Cholesky does)."""
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    vec = b.dim() == 1
    x = torch.cholesky_solve(b[:, None] if vec else b, L)
    x = x[:, 0] if vec else x
    return _nan_unless(x, info == 0)


def _ridge_fallback(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Damped normal equations ``(AᴴA + λI) x = Aᴴ b`` with
    ``λ = √eps · max(diag(AᴴA)) + tiny``: the JAX package's rank-deficient
    retry for square systems."""
    Ah = A.conj().T
    G = Ah @ A
    fi = torch.finfo(A.real.dtype if A.is_complex() else A.dtype)
    lam = (fi.eps ** 0.5 * torch.max(G.diagonal().real) + fi.tiny)
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return _square_solve(G + lam * eye, Ah @ b)


def solve_dense(A: torch.Tensor, b: torch.Tensor,
                cfg: LinearSolver = LinearSolver(), *, verbosity=None):
    """Solve ``A x = b``; returns ``(x, ok)`` with ``ok`` a 0-d device bool
    (x finite).  'auto' is LU for square and least squares for non-square
    systems.  LU, Cholesky and QR results that are not finite on finite
    inputs are retried with the ridge fallback, the JAX package's contract
    (see the module docstring for when that decision is read); the linear
    ``rank_deficient_fallback`` message says so when ``verbosity`` has it
    on."""
    m, n = A.shape
    method = cfg.method
    if method == "auto":
        method = "lu" if m == n else "qr"
    if method == "sparse_lu_device":
        # the device-applied sparse factor on a dense Jacobian: dense LU
        method = "lu"

    if method == "diagonal":
        x = b / A.diagonal()
    elif method == "cholesky":
        x = _cholesky_solve(A, b)
    elif method == "svd":
        x = _lstsq(A, b)[0]
    elif method == "qr":
        if m == n:
            q, r = torch.linalg.qr(A)
            rhs = q.conj().T @ b
            vec = rhs.dim() == 1
            x = torch.linalg.solve_triangular(
                r, rhs[:, None] if vec else rhs, upper=True)
            x = x[:, 0] if vec else x
        else:
            x = _lstsq(A, b)[0]
    elif method == "lu":
        x = _square_solve(A, b)
    else:
        raise ValueError(f"solve_dense cannot handle method {method!r}")

    ok = torch.isfinite(x).all()
    if method in ("lu", "cholesky", "qr"):
        if _decide(~ok & _all_finite(A, b)):
            from ..core.verbosity import traced_emit_linear
            traced_emit_linear(
                verbosity, "rank_deficient_fallback", True,
                "factorization produced non-finite values on finite inputs "
                "— retrying with the damped-normal-equation fallback "
                "(linear_solve.jl:48-56 role)")
            x = _ridge_fallback(A, b)
            ok = torch.isfinite(x).all()
    return x, ok


def solve_spd(A: torch.Tensor, b: torch.Tensor):
    """Cholesky with the LU route of ``solve_dense`` as its fallback (the
    JAX package's ``solve_spd``)."""
    x = _cholesky_solve(A, b)
    ok = torch.isfinite(x).all()
    if _decide(~ok):
        x = solve_dense(A, b)[0]
        ok = torch.isfinite(x).all()
    return x, ok


# ---------------------------------------------------------------------------
# batched square solves (the simple tier and ensembles)
# ---------------------------------------------------------------------------

def gauss_jordan_batched(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``gauss_jordan_solve`` on a batch: ``A`` (B, n, n), ``b`` (B, n).
    Row ``i`` of the result is ``gauss_jordan_solve(A[i], b[i])`` bit for
    bit: the host helper loops over the rows, and on the card the
    tensor operations act on each matrix alone (one CUDA graph a shape,
    batch size included)."""
    n = A.shape[-1]
    M = torch.cat([A, b[..., None]], dim=-1)              # (B, n, n+1)
    if M.device.type == "cpu" and M.dtype in (torch.float32, torch.float64):
        from ..native import gauss_jordan
        return gauss_jordan(M.contiguous())[..., n]
    if M.device.type == "cuda":
        return _gauss_jordan_graph(M, n, True)
    return _gauss_jordan_ops(M, n, True)


def _batched_square_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Gauss–Jordan for n ≤ 32, else batched LU (``solve_ex``) with a
    row of NaN where its ``info`` reports a zero pivot."""
    if A.shape[-1] <= _GJ_MAX_N:
        return gauss_jordan_batched(A, b)
    x, info = torch.linalg.solve_ex(A, b, check_errors=False)
    return _nan_unless(x, (info == 0)[..., None])


def _batched_ridge_fallback(A: torch.Tensor, b: torch.Tensor):
    """``_ridge_fallback`` on each matrix of a batch, λ per matrix."""
    Ah = A.mH
    G = Ah @ A
    fi = torch.finfo(A.real.dtype if A.is_complex() else A.dtype)
    lam = fi.eps ** 0.5 * G.diagonal(dim1=-2, dim2=-1).real.amax(-1) \
        + fi.tiny
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return _batched_square_solve(G + lam[..., None, None] * eye,
                                 (Ah @ b[..., None])[..., 0])


def solve_dense_batched(A: torch.Tensor, b: torch.Tensor):
    """``solve_dense(A[i], b[i])`` ('auto' on square systems: LU) for
    every row of a batch, as the JAX package's ``solve_dense`` runs under
    ``vmap``: the ridge fallback is computed for every row and taken
    where the primary result is not finite on finite inputs (its
    ``lax.cond`` batches to a select), so nothing is read to the host.
    ``A`` (B, n, n), ``b`` (B, n); returns ``(x, ok)``, ``ok`` (B,) bool."""
    x = _batched_square_solve(A, b)
    finite_in = (torch.isfinite(A).flatten(-2).all(-1)
                 & torch.isfinite(b).all(-1))
    want = ~torch.isfinite(x).all(-1) & finite_in
    x = torch.where(want[..., None], _batched_ridge_fallback(A, b), x)
    return x, torch.isfinite(x).all(-1)

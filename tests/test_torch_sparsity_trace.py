"""Sparsity detection (ROADMAP A.25) against the JAX package, f64 on the
CPU: the exact ATen-graph tracer (``ops/sparsity_trace.py``), its front
end (``ops/_graph.py``), ``ops.coloring.detect_sparsity`` with its probe
fallback and guard, and a sparse solve built from a detected pattern.

Each residual of ``tests/test_sparse_krylov.py``'s
``TestExactSparsityTracer`` is written once in JAX and once in torch: the
two detected patterns must be equal, and must cover the nonzeros of a
dense Jacobian (``torch.func.jacfwd`` at a seeded point), since the JAX
tracer can under-approximate (ROADMAP C, caveats).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import torch.nn.functional as F

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.ops import coloring as jcol
from nonlinearsolve_tpu.ops.preconditioners import \
    fft_poisson_preconditioner as jfft
from nonlinearsolve_tpu.ops.sparsity_trace import \
    detect_sparsity_exact as jexact
from nonlinearsolve_tpu.solvers.first_order import \
    EisenstatWalkerForcing as JEW
from nonlinearsolve_tpu_torch.core import solve as tsolve
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.ops import _graph
from nonlinearsolve_tpu_torch.ops import coloring as tcol
from nonlinearsolve_tpu_torch.ops.preconditioners import \
    fft_poisson_preconditioner as tfft
from nonlinearsolve_tpu_torch.ops.sparsity_trace import \
    detect_sparsity_exact as texact

torch.set_num_threads(1)


def _mask(csr, n):
    m = np.zeros((csr.shape[0], n), bool)
    m[csr.row_ids, csr.indices] = True
    return m


def _dense_nonzeros(tf, n, seed=3):
    u = torch.tensor(np.random.default_rng(seed).standard_normal(n))
    return (torch.func.jacfwd(tf)(u) != 0).reshape(-1, n).numpy()


def _same_pattern(jf, tf, n):
    """Both tracers' patterns, equal to each other and covering the dense
    Jacobian's nonzeros; returns the port's mask."""
    jp, tp = jexact(jf, n), texact(tf, n, device="cpu")
    assert jp is not None and tp is not None
    jm, tm = _mask(jp, n), _mask(tp, n)
    np.testing.assert_array_equal(tm, jm)
    assert not (_dense_nonzeros(tf, n) & ~tm).any()
    return tm


A12 = np.random.default_rng(0).standard_normal((12, 12))
A12[np.abs(A12) < 1.2] = 0.0
W = np.random.default_rng(0).standard_normal((2, 4, 3))
IDX = np.array([3, 1, 2, 0, 7, 6, 5, 4])
SIDX = np.array([1, 3, 3, 5])


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.as_tensor(x)


def _t_set(u):
    # JAX's .at[...].set is a scatter: its counterpart is index_put
    return u.index_put((torch.arange(2, 5),), u[:3] * 2.0)


def _t_update(u):
    # slice assignment is JAX's dynamic_update_slice
    out = u.clone()
    out[4:6] = u[:2] * 3
    return out


def _t_scatter_set(u):
    out = torch.zeros(8, dtype=u.dtype)
    out[_t([1, 3, 5, 6])] = u[:4]
    return out + u


CASES = {
    "roll_stencil": (
        lambda u: jnp.roll(u, 1) + jnp.roll(u, -1) - 2 * u + u ** 3,
        lambda u: torch.roll(u, 1) + torch.roll(u, -1) - 2 * u + u ** 3, 32),
    "pad_stencil": (
        lambda u: jnp.pad(u[1:], (0, 1)) + jnp.pad(u[:-1], (1, 0)) - 2 * u,
        lambda u: F.pad(u[1:], (0, 1)) + F.pad(u[:-1], (1, 0)) - 2 * u, 16),
    "reverse_transpose_concat": (
        lambda u: jnp.concatenate([u[::-1][:5], u.reshape(4, 4).T.reshape(-1)]),
        lambda u: torch.cat([torch.flip(u, (0,))[:5],
                             u.reshape(4, 4).T.reshape(-1)]), 16),
    "const_matrix_plus_square": (
        lambda u: _j(A12) @ u + u ** 2, lambda u: _t(A12) @ u + u ** 2, 12),
    "reductions": (
        lambda u: jnp.array([u[:4].sum(), u[4:].max()]),
        lambda u: torch.stack([u[:4].sum(), u[4:].max()]), 8),
    "cumsum": (jnp.cumsum, lambda u: torch.cumsum(u, 0), 8),
    "reverse_cumsum": (
        lambda u: jnp.cumsum(u[::-1])[::-1],
        lambda u: torch.flip(torch.cumsum(torch.flip(u, (0,)), 0), (0,)), 8),
    "batched_einsum": (
        lambda u: jnp.einsum("bij,bjk->bik", u.reshape(2, 3, 4),
                             _j(W)).reshape(-1),
        lambda u: torch.einsum("bij,bjk->bik", u.reshape(2, 3, 4),
                               _t(W)).reshape(-1), 24),
    "split": (
        lambda u: jnp.split(u, 2)[0] * jnp.split(u, 2)[1],
        lambda u: torch.split(u, 4)[0] * torch.split(u, 4)[1], 8),
    "gather": (lambda u: u[_j(IDX)] + u ** 2,
               lambda u: u[_t(IDX)] + u ** 2, 8),
    "take_repeat": (lambda u: jnp.take(u, _j([0, 0, 1, 2])),
                    lambda u: torch.index_select(u, 0, _t([0, 0, 1, 2])), 4),
    "slice_set": (lambda u: u.at[2:5].set(u[:3] * 2.0), _t_set, 8),
    "scatter_add_dups": (
        lambda u: jnp.zeros(8).at[_j(SIDX)].add(u[:4]) + u,
        lambda u: torch.zeros(8, dtype=u.dtype).index_add(
            0, _t(SIDX), u[:4]) + u, 8),
    "scatter_set": (
        lambda u: jnp.zeros(8).at[_j([1, 3, 5, 6])].set(u[:4]) + u,
        _t_scatter_set, 8),
    "dynamic_slice": (
        lambda u: jax.lax.dynamic_slice(u, (2,), (3,)) + u[:3],
        lambda u: u[2:5] + u[:3], 8),
    "dynamic_update_slice": (
        lambda u: jax.lax.dynamic_update_slice(u, u[:2] * 3, (4,)),
        _t_update, 8),
    "row_gather": (
        lambda u: u.reshape(4, 4)[_j([2, 0]), :].reshape(-1),
        lambda u: u.reshape(4, 4)[_t([2, 0]), :].reshape(-1), 16),
    "row_scatter_add": (
        lambda u: jnp.zeros((4, 4)).at[_j([1, 2]), :].add(
            u.reshape(2, 8)[:, :4]).reshape(-1),
        lambda u: torch.zeros((4, 4), dtype=u.dtype).index_put(
            (_t([1, 2]),), u.reshape(2, 8)[:, :4],
            accumulate=True).reshape(-1), 16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pattern_equals_jax_and_covers_the_jacobian(case):
    jf, tf, n = CASES[case]
    _same_pattern(jf, tf, n)


def test_const_matrix_dot_is_exact():
    """``A @ u`` with a constant (dense-stored) tridiagonal matrix gives
    A's pattern, not dense rows; on either side and batched too."""
    n = 64
    d = np.ones(n)
    A = sp.diags([3.0 * d, -d[:-1], -d[:-1]], [0, 1, -1], format="csr")
    Ad = A.toarray()
    m = _same_pattern(lambda u: _j(Ad) @ u + 0.1 * u ** 3,
                      lambda u: _t(Ad) @ u + 0.1 * u ** 3, n)
    assert m.sum() == A.nnz
    m2 = _same_pattern(lambda u: u @ _j(Ad) + u, lambda u: u @ _t(Ad) + u, n)
    assert m2.sum() == A.nnz
    Wb = np.where(np.abs(np.random.default_rng(4).standard_normal((2, 4, 3)))
                  > 1.0, 1.0, 0.0)
    tf = (lambda u: torch.einsum("bij,bjk->bik", u.reshape(2, 3, 4),
                                 _t(Wb)).reshape(-1))
    m3 = _same_pattern(
        lambda u: jnp.einsum("bij,bjk->bik", u.reshape(2, 3, 4),
                             _j(Wb)).reshape(-1), tf, 24)
    np.testing.assert_array_equal(m3, _dense_nonzeros(tf, 24))


def test_pad_stencil_at_64_squared():
    """The 8192-unknown two-component pad stencil traces exactly: the
    pattern is the hand-assembled [[5pt, diag], [diag, 5pt]] and the JAX
    tracer's."""
    N = 64
    n = 2 * N * N

    def jf(u):
        U = u.reshape(N, N, 2)
        Up = jnp.pad(U, ((1, 1), (1, 1), (0, 0)))
        lap = (Up[:-2, 1:-1] + Up[2:, 1:-1] + Up[1:-1, :-2]
               + Up[1:-1, 2:] - 4 * U)
        a, b = U[..., 0], U[..., 1]
        return jnp.stack([lap[..., 0] + 1.0 + a * a * b - 4.0 * a,
                          lap[..., 1] + 3.0 * a - a * a * b],
                         axis=-1).reshape(-1)

    def tf(u):
        U = u.reshape(N, N, 2)
        Up = F.pad(U, (0, 0, 1, 1, 1, 1))
        lap = (Up[:-2, 1:-1] + Up[2:, 1:-1] + Up[1:-1, :-2]
               + Up[1:-1, 2:] - 4 * U)
        a, b = U[..., 0], U[..., 1]
        return torch.stack([lap[..., 0] + 1.0 + a * a * b - 4.0 * a,
                            lap[..., 1] + 3.0 * a - a * a * b],
                           dim=-1).reshape(-1)

    tp = texact(tf, n, device="cpu")
    jp = jexact(jf, n)
    np.testing.assert_array_equal(tp.indptr, jp.indptr)
    np.testing.assert_array_equal(tp.indices, jp.indices)
    d1 = np.ones(N)
    T1 = sp.diags([d1, d1[:-1], d1[:-1]], [0, 1, -1], format="csr")
    I1 = sp.identity(N, format="csr")
    L = ((sp.kron(I1, T1) + sp.kron(T1, I1)) != 0).astype(np.float64).tocsr()
    I = sp.identity(N * N, format="csr")
    rows, cols = [], []
    for rr, cc, M in ((0, 0, L), (0, 1, I), (1, 0, I), (1, 1, L)):
        Mc = M.tocoo()
        rows.append(2 * Mc.row + rr)
        cols.append(2 * Mc.col + cc)
    ref = sp.csr_matrix((np.ones(sum(len(r) for r in rows)),
                         (np.concatenate(rows), np.concatenate(cols))),
                        shape=(n, n))
    ref.sort_indices()
    got = sp.csr_matrix((np.ones(tp.nnz), tp.indices, tp.indptr),
                        shape=(n, n))
    assert (got != ref).nnz == 0


def test_catches_entries_probing_misses():
    """An entry whose derivative vanishes at both probe points (seed 0):
    the tracer keeps it, in both packages, and detect_sparsity returns
    the exact pattern."""
    rng = np.random.default_rng(0)
    a = float((rng.standard_normal(2) * 0.5 + 0.3)[1])
    b = float((rng.standard_normal(2) * 0.5 + 0.3)[1])

    def jf(u):
        return jnp.array([u[0] + (u[1] - a) ** 2 * (u[1] - b) ** 2,
                          2.0 * u[1]])

    def tf(u):
        return torch.stack([u[0] + (u[1] - a) ** 2 * (u[1] - b) ** 2,
                            2.0 * u[1]])

    m = _same_pattern(jf, tf, 2)
    assert m[0, 1]
    assert _mask(tcol.detect_sparsity(tf, 2, device="cpu"), 2)[0, 1]


def _data_dependent(n):
    def jf(u):
        j = jnp.clip(jnp.int32(u[0]), 0, n - 1)
        return u * jax.lax.dynamic_index_in_dim(u, j, keepdims=False)

    def tf(u):
        j = torch.clamp(u[0].to(torch.int64), 0, n - 1)
        return u * u[j]
    return jf, tf


def test_unsupported_falls_back_to_the_jax_probe_pattern():
    """A data-dependent index and data-dependent control flow are
    unsupported (None); detect_sparsity then probes at the JAX package's
    seeded points and gets its pattern."""
    jf, tf = _data_dependent(3)
    assert jexact(jf, 3) is None
    assert texact(tf, 3, device="cpu") is None

    def branch(u):
        return u if u.sum() > 0 else -u
    with pytest.raises(_graph.GraphTraceError):
        _graph.trace(branch, torch.zeros(3, dtype=torch.float64))
    assert texact(branch, 3, device="cpu") is None
    for seed in (0, 5):
        jp = jcol.detect_sparsity(jf, 3, seed=seed)
        tp = tcol.detect_sparsity(tf, 3, seed=seed, device="cpu")
        np.testing.assert_array_equal(_mask(tp, 3), _mask(jp, 3))
        assert tp.nnz >= 3
    # a constant-index gather traces exactly
    m = _mask(texact(lambda u: u[_t([2, 0, 1])], 3, device="cpu"), 3)
    assert m[0, 2] and m[1, 0] and m[2, 1] and m.sum() == 3


def test_probe_guard_raises_informative():
    _, tf = _data_dependent(8192)
    with pytest.raises(ValueError, match="sparsity"):
        tcol.detect_sparsity(tf, 8192, device="cpu")


@pytest.mark.parametrize("N", [8, 16])
def test_brusselator_patterns_plain_and_permuted(N):
    """The flagship residual's pattern is ``sparsity_pattern(N)``; the
    permuted residual (w = u[perm], G(w) = F(w[pinv])[perm]) gives
    (pinv[rows], pinv[cols]); both the JAX tracer's."""
    n = 2 * N * N
    tp_ = tbru.default_p(N, device="cpu")
    jp_ = jbru.default_p(N)
    ref = tbru.sparsity_pattern(N)
    got = tcol.detect_sparsity(
        lambda u: tbru.brusselator_2d(u.reshape(N, N, 2), tp_).reshape(-1),
        n, device="cpu")
    np.testing.assert_array_equal(got.indptr, ref.indptr)
    np.testing.assert_array_equal(got.indices, ref.indices)
    perm = np.random.default_rng(42).permutation(n)
    pinv = np.argsort(perm)
    tperm, tpinv = torch.as_tensor(perm), torch.as_tensor(pinv)
    jperm, jpinv = jnp.asarray(perm), jnp.asarray(pinv)

    def tg(w):
        return tbru.brusselator_2d(w[tpinv].reshape(N, N, 2),
                                   tp_).reshape(-1)[tperm]

    def jg(w):
        return jbru.brusselator_2d(w[jpinv].reshape(N, N, 2),
                                   jp_).reshape(-1)[jperm]

    m = _same_pattern(jg, tg, n)
    want = np.zeros((n, n), bool)
    want[pinv[ref.row_ids], pinv[ref.indices]] = True
    np.testing.assert_array_equal(m, want)


def test_sparse_solve_without_a_pattern_matches_jax():
    """NewtonRaphson with sparse AD (GMRES(8), the FFT preconditioner,
    η = 0.1) on the flat N = 8 Brusselator and no ``sparsity=``: the port
    detects the pattern, builds the analytic pattern's plan, and gives the
    JAX package's retcode, NLStats and root (the JAX package detecting
    too); the solve equals the one built from the analytic pattern bit for
    bit."""
    N = 8
    u0 = np.asarray(jbru.init_u0(N)).reshape(-1)
    p = np.asarray(jbru.default_p(N))

    def jf(u, p_):
        return jbru.brusselator_2d(u.reshape(N, N, 2), p_).reshape(-1)

    def tf(u, p_):
        return tbru.brusselator_2d(u.reshape(N, N, 2), p_).reshape(-1)

    fft = dict(alpha=10.0, h=1.0 / (N - 1), shift=3.0, n_components=2)
    kw = dict(method="gmres", restart=8, krylov_maxiter=100)
    jsol = jnls.solve(jnls.NonlinearProblem(jf, jnp.asarray(u0),
                                            jnp.asarray(p)),
                      jnls.NewtonRaphson(
                          autodiff=jnls.JacobianPolicy(mode="sparse"),
                          linsolve=jnls.LinearSolver(
                              precond_fn=jfft((N, N), **fft), **kw),
                          forcing=JEW(eta_0=0.1, eta_max=0.1)),
                      abstol=1e-8, maxiters=30)
    talg = tnls.NewtonRaphson(
        autodiff=tnls.JacobianPolicy(mode="sparse"),
        linsolve=tnls.LinearSolver(precond_fn=tfft((N, N), **fft), **kw),
        forcing=tnls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    detected = tnls.NonlinearFunction(f=tf)
    tsol = tnls.solve(tnls.NonlinearProblem(detected, torch.tensor(u0),
                                            torch.tensor(p)), talg,
                      abstol=1e-8, maxiters=30)
    given = tnls.solve(tnls.NonlinearProblem(
        tnls.NonlinearFunction(f=tf, sparsity=tbru.sparsity_pattern(N)),
        torch.tensor(u0), torch.tensor(p)), talg, abstol=1e-8, maxiters=30)
    stats = ("nf", "njacs", "nfactors", "nsolve", "nsteps")
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert {k: int(getattr(tsol.stats, k)) for k in stats} == \
        {k: int(getattr(jsol.stats, k)) for k in stats}
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-10)
    assert torch.equal(tsol.u, given.u)
    assert {k: getattr(tsol.stats, k) for k in stats} == \
        {k: getattr(given.stats, k) for k in stats}
    plan, = tsolve._SPARSE_PLANS[detected].values()
    np.testing.assert_array_equal(plan.pattern.indices,
                                  tbru.sparsity_pattern(N).indices)

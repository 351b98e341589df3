"""The port's sparse direct solvers (nonlinearsolve_tpu_torch/ops/
direct_sparse.py and the native LU bindings of nonlinearsolve_tpu_torch/
native.py) against the JAX package's, on the inputs of
tests/test_direct_sparse.py made from the same numpy seeds: parallel cyclic
reduction, block cyclic reduction, RCM band recovery, the AMD host LU, its
fill diagnostic, failure on a singular system, factor reuse, re-pivoting,
and the BiCGStab route above ``_HOST_LU_MAX_N`` (lowered to 100 in both
packages).  Each solve must take the route the JAX package takes
(``_backend.ROUTES``).

Tolerances: x rel-inf 1e-12 (f64: the same algorithms, sums in another
order); for BiCGStab the solve's own accuracy (see its test); Newton
solves: the same retcode and NLStats, roots within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu.ops.direct_sparse as jds
import nonlinearsolve_tpu.ops.krylov as jkry
import nonlinearsolve_tpu_torch as tnls
import nonlinearsolve_tpu_torch.ops.direct_sparse as tds
import nonlinearsolve_tpu_torch.ops.krylov as tkry
from nonlinearsolve_tpu import native as jnat
from nonlinearsolve_tpu.ops.sparse import CSR as JCSR, DIA as JDIA
from nonlinearsolve_tpu_torch import _backend, native as tnat
from nonlinearsolve_tpu_torch.ops.sparse import CSR as TCSR, DIA as TDIA

torch.set_num_threads(2)

STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-300)


def _csrs(A):
    """A scipy CSR matrix as the JAX and the port containers."""
    A = sp.csr_matrix(A)
    n = A.shape[0]
    idx, ptr = np.asarray(A.indices, np.int32), np.asarray(A.indptr, np.int32)
    return (JCSR(jnp.asarray(A.data), idx, ptr, (n, n)),
            TCSR(torch.tensor(A.data), idx, ptr, (n, n)))


def _direct(A, b, route, jit=True):
    """solve_sparse_direct in both packages (the JAX one jitted: one
    compile instead of one for each eager operation); the port must take
    ``route`` once; returns (jax x, jax ok, port x, port ok)."""
    jA, tA = _csrs(A)
    jsolve = jds.solve_sparse_direct
    if jit:
        jsolve = jax.jit(lambda data, v: jds.solve_sparse_direct(
            JCSR(data, jA.indices, jA.indptr, jA.shape), v))
        xj, okj = jsolve(jA.data, jnp.asarray(b))
    else:
        xj, okj = jsolve(jA, jnp.asarray(b))
    _backend.reset_counters()
    xt, okt = tds.solve_sparse_direct(tA, torch.tensor(b))
    assert _backend.ROUTES == {**dict.fromkeys(_backend.ROUTES, 0), route: 1}
    return np.asarray(xj), bool(okj), xt.numpy(), bool(okt)


@pytest.mark.parametrize("n", [4, 17, 64, 257])
def test_pcr_matches_jax(n):
    rng = np.random.default_rng(n)
    d = 4.0 + rng.random(n)
    dl = rng.standard_normal(n)
    du = rng.standard_normal(n)
    b = rng.standard_normal(n)
    xj = jax.jit(jds.tridiagonal_solve_pcr)(*map(jnp.asarray,
                                                 (dl, d, du, b)))
    xt = tds.tridiagonal_solve_pcr(*map(torch.tensor, (dl, d, du, b)))
    assert _rel(xt, xj) <= 1e-12
    A = np.diag(d) + np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    np.testing.assert_allclose(xt.numpy(), np.linalg.solve(A, b),
                               rtol=1e-9, atol=1e-9)


def test_tridiagonal_csr_routes_to_pcr():
    n = 32
    rng = np.random.default_rng(0)
    A = (np.diag(3.0 + rng.random(n)) + np.diag(rng.random(n - 1), 1)
         + np.diag(rng.random(n - 1), -1))
    b = rng.standard_normal(n)
    xj, okj, xt, okt = _direct(A, b, "pcr")
    assert okj and okt and _rel(xt, xj) <= 1e-12


def _banded(n, kl, ku, seed):
    """tests/test_direct_sparse.py's diagonally dominant banded matrix."""
    rng = np.random.default_rng(seed)
    offs = list(range(-kl, ku + 1))
    data = np.zeros((len(offs), n))
    A = np.zeros((n, n))
    for k, off in enumerate(offs):
        for i in range(n):
            j = i + off
            if 0 <= j < n:
                A[i, j] = rng.standard_normal()
                data[k, i] = A[i, j]
    A += np.diag(np.abs(A).sum(1) + 1.0)
    data[kl] = np.diag(A)
    return A, data, offs


@pytest.mark.parametrize("n,kl,ku", [(50, 2, 2), (64, 3, 1), (37, 5, 5),
                                     (100, 1, 4), (33, 7, 2)])
def test_block_cyclic_reduction_matches_jax(n, kl, ku):
    A, data, offs = _banded(n, kl, ku, seed=n + kl)
    b = np.random.default_rng(1).standard_normal(n)
    xj, okj = jax.jit(lambda dd, v: jds.banded_solve(
        JDIA(dd, offs, (n, n)), v))(jnp.asarray(data), jnp.asarray(b))
    _backend.reset_counters()
    xt, okt = tds.banded_solve(TDIA(torch.tensor(data), offs, (n, n)),
                               torch.tensor(b))
    assert bool(okj) and bool(okt) and _backend.ROUTES["bcr"] == 1
    assert _rel(xt, xj) <= 1e-12
    np.testing.assert_allclose(A @ xt.numpy(), b, atol=1e-9)


def test_banded_csr_routes_to_bcr():
    A, _, _ = _banded(80, 3, 3, seed=7)
    b = np.random.default_rng(2).standard_normal(80)
    xj, okj, xt, okt = _direct(A, b, "bcr")
    assert okj and okt and _rel(xt, xj) <= 1e-12


def test_rcm_recovers_scrambled_band():
    rng = np.random.default_rng(0)
    n = 120
    A0, _, _ = _banded(n, 3, 3, seed=9)
    sigma = rng.permutation(n)
    A = A0[np.ix_(sigma, sigma)]
    b = rng.standard_normal(n)
    xj, okj, xt, okt = _direct(A, b, "rcm_bcr")
    assert okj and okt and _rel(xt, xj) <= 1e-12


def test_small_unstructured_goes_dense():
    rng = np.random.default_rng(3)
    A = np.eye(40) * 5 + ((rng.random((40, 40)) < 0.2)
                          * rng.standard_normal((40, 40)))
    b = rng.standard_normal(40)
    xj, okj, xt, okt = _direct(A, b, "dense")
    assert okj and okt and _rel(xt, xj) <= 1e-12


def _grid_laplacian(N, rng):
    """tests/test_direct_sparse.py's 2D 5-point Laplacian, slightly
    asymmetric."""
    n = N * N
    A = sp.lil_matrix((n, n))
    for i in range(N):
        for j in range(N):
            k = i * N + j
            A[k, k] = 4.0 + 0.1 * rng.random()
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < N and 0 <= jj < N:
                    A[k, ii * N + jj] = -1.0 + 0.01 * rng.standard_normal()
    return A.tocsr()


def test_host_lu_on_a_nonbanded_scrambled_pattern():
    """A permuted grid Laplacian (n = 576) with 60 long-range couplings:
    no ordering makes it banded enough for block cyclic reduction."""
    rng = np.random.default_rng(5)
    A = _grid_laplacian(24, rng).tolil()
    n = A.shape[0]
    for _ in range(60):
        i, j = rng.integers(0, n, 2)
        A[i, j] = 0.5 * rng.standard_normal()
    sigma = rng.permutation(n)
    A = A.tocsr()[np.ix_(sigma, sigma)].tocsr()
    b = rng.standard_normal(n)
    xj, okj, xt, okt = _direct(A, b, "host_lu")
    assert okj and okt and _rel(xt, xj) <= 1e-12
    np.testing.assert_allclose(A @ xt, b, atol=1e-8)


@pytest.mark.parametrize("ordering", ["amd", "rcm", "natural"])
def test_sparse_lu_fill_equals_jax(ordering):
    A = _grid_laplacian(32, np.random.default_rng(0))
    jA, tA = _csrs(A)
    fill = tds.sparse_lu_fill(tA, ordering=ordering)
    assert fill == jds.sparse_lu_fill(jA, ordering=ordering)
    if ordering == "amd":
        assert fill < tds.sparse_lu_fill(tA, ordering="natural")
        assert fill < 0.05 * A.shape[0] ** 2


def test_singular_system_reports_failure():
    n = 100
    A = sp.diags(np.where(np.arange(n) == n // 2, 0.0, 1.0)).tocsr()
    A = (A + sp.random(n, n, density=0.05, random_state=2)).tolil()
    A[n // 2, :] = 0.0
    jA, tA = _csrs(A.tocsr())
    xj, okj = jds._host_sparse_lu_solve(jA, jnp.ones(n))
    xt, okt = tds._host_sparse_lu_solve(tA, torch.ones(n,
                                                      dtype=torch.float64))
    assert not bool(okj) and not bool(okt)
    assert np.isnan(np.asarray(xj)).all() and torch.isnan(xt).all()


def _bratu_csr(N, rng):
    n = N * N
    d = np.ones(n)
    A = sp.diags([d * 4, -d[:-1], -d[:-1], -d[:-N], -d[:-N]],
                 [0, 1, -1, N, -N], format="csr")
    return (A + sp.diags(0.1 * rng.standard_normal(n))).tocsr()


def test_factor_refactors_as_jax():
    rng = np.random.default_rng(0)
    A = _bratu_csr(16, rng)
    n = A.shape[0]
    b = rng.standard_normal(n)
    A2 = A.copy()
    A2.data = A.data * (1 + 0.25 * rng.standard_normal(A.nnz))
    xs = []
    for nat in (jnat, tnat):
        fac = nat.SpLuFactor(A.indptr, A.indices, n,
                             perm=nat.amd_ordering(A.indptr, A.indices, n))
        assert fac.factorize(A.data) == 0
        x1 = fac.solve(b)
        assert fac.factorize(A2.data) == 0
        xs.append((x1, fac.solve(b), fac.n_factor, fac.n_refactor,
                   fac.fill, fac.export_factor()))
    (j1, j2, jf, jr, jfill, jexp), (t1, t2, tf, tr, tfill, texp) = xs
    assert (tf, tr, tfill) == (jf, jr, jfill) == (1, 1, jfill)
    assert _rel(t1, j1) <= 1e-12 and _rel(t2, j2) <= 1e-12
    np.testing.assert_allclose(A2 @ t2, b, atol=1e-9)
    for key in ("Lp", "Lrow", "Up", "Urow", "in_perm", "out_perm"):
        assert np.array_equal(texp[key], jexp[key]), key
    for key in ("Lval", "Uval", "Ud"):
        assert _rel(texp[key], jexp[key]) <= 1e-12, key


def test_degraded_pivot_repivots_as_jax():
    n = 40
    A = sp.random(n, n, density=0.3, random_state=4).tocsr()
    A = (A + sp.diags(np.full(n, 5.0))).tocsr()
    A2 = A.copy()
    A2.data = A.data.copy()
    A2.data[A.indices == np.repeat(np.arange(n), np.diff(A.indptr))] = 1e-14
    b = np.random.default_rng(3).standard_normal(n)
    out = []
    for nat in (jnat, tnat):
        fac = nat.SpLuFactor(A.indptr, A.indices, n)
        assert fac.factorize(A.data) == 0
        assert fac.factorize(A2.data) == 0
        out.append((fac.solve(b), fac.n_factor, fac.n_refactor))
    (xj, jf, jr), (xt, tf, tr) = out
    assert (tf, tr) == (jf, jr) == (2, 0)       # re-pivoted, not degraded
    assert _rel(xt, xj) <= 1e-12
    np.testing.assert_allclose(A2 @ xt, b, atol=1e-6)


def _scrambled_newton(mod, lib):
    """tests/test_direct_sparse.py's non-banded Newton problem (n = 96),
    with its pattern given (the port has no sparsity detection: ROADMAP
    A.25): row i couples i, n-1-i and its two neighbours in the scrambled
    order."""
    n = 96
    sigma = np.random.default_rng(11).permutation(n)
    back = np.argsort(sigma)
    i = np.arange(n)
    rows = np.repeat(i, 4)
    cols = np.stack([i, n - 1 - i, sigma[(back - 1) % n],
                     sigma[(back + 1) % n]], axis=1).reshape(-1)
    keep = np.unique(rows * n + cols)
    spec = (keep // n, keep % n)

    def f(u, p):
        v = u[sigma]
        w = lib.roll(v, 1) + lib.roll(v, -1)
        return u + 0.3 * w[back] + 0.1 * u ** 3 + lib.flip(u, (0,)) * 0.05 \
            - 1.0

    u0 = (torch.zeros(n, dtype=torch.float64) if lib is torch
          else jnp.zeros(n))
    return (mod.NonlinearProblem(mod.NonlinearFunction(f=f, sparsity=spec),
                                 u0),
            mod.NewtonRaphson(autodiff=mod.JacobianPolicy(mode="sparse"),
                              concrete_jac=True))


def test_newton_steps_reuse_the_factor():
    """Newton steps after the first refactor numerically on the cached
    pattern, in both packages: one factorization, the same refactorings."""
    jds._FACTORS._d.clear()
    tds._FACTORS._d.clear()
    jprob, jalg = _scrambled_newton(jnls, jnp)
    tprob, talg = _scrambled_newton(tnls, torch)
    jsol = jnls.solve(jprob, jalg, abstol=1e-10)
    _backend.reset_counters()
    tsol = tnls.solve(tprob, talg, abstol=1e-10)
    _assert_same_solve(jsol, tsol)
    assert _backend.ROUTES["host_lu"] == tsol.stats.nsolve
    (jfac,), (tfac,) = jds._FACTORS._d.values(), tds._FACTORS._d.values()
    assert tfac.n_factor == jfac.n_factor == 1
    assert tfac.n_refactor == jfac.n_refactor >= 1


def _assert_same_solve(jsol, tsol):
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert {k: int(getattr(tsol.stats, k)) for k in STATS} == \
        {k: int(getattr(jsol.stats, k)) for k in STATS}
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               rtol=0, atol=1e-10)


def test_newton_pentadiagonal_coo_spec_routes_to_bcr():
    """tests/test_direct_sparse.py's bandwidth-2 Newton problem (a COO
    spec): block cyclic reduction at every step."""
    n = 120
    rows = [i for i in range(n) for _ in range(max(0, i - 2),
                                               min(n, i + 3))]
    cols = [j for i in range(n) for j in range(max(0, i - 2),
                                               min(n, i + 3))]
    spec = (np.array(rows), np.array(cols))

    def jf(u, p):
        up1 = jnp.pad(u[1:], (0, 1))
        um1 = jnp.pad(u[:-1], (1, 0))
        up2 = jnp.pad(u[2:], (0, 2))
        um2 = jnp.pad(u[:-2], (2, 0))
        return (0.01 * (-um2 + 4 * um1 - 6 * u + 4 * up1 - up2)
                + u + 0.1 * u ** 3 - p)

    def tf(u, p):
        pad = torch.nn.functional.pad
        up1, um1 = pad(u[1:], (0, 1)), pad(u[:-1], (1, 0))
        up2, um2 = pad(u[2:], (0, 2)), pad(u[:-2], (2, 0))
        return (0.01 * (-um2 + 4 * um1 - 6 * u + 4 * up1 - up2)
                + u + 0.1 * u ** 3 - p)

    jsol = jnls.solve(
        jnls.NonlinearProblem(jnls.NonlinearFunction(f=jf, sparsity=spec),
                              jnp.zeros(n), 0.7 * jnp.ones(n)),
        jnls.NewtonRaphson(autodiff=jnls.JacobianPolicy(mode="sparse")))
    _backend.reset_counters()
    tsol = tnls.solve(
        tnls.NonlinearProblem(tnls.NonlinearFunction(f=tf, sparsity=spec),
                              torch.zeros(n, dtype=torch.float64),
                              torch.full((n,), 0.7, dtype=torch.float64)),
        tnls.NewtonRaphson(autodiff=tnls.JacobianPolicy(mode="sparse")))
    _assert_same_solve(jsol, tsol)
    assert _backend.ROUTES["bcr"] == tsol.stats.nsolve


@pytest.mark.parametrize("diag", [8.0, 4.0])
def test_iterative_route_above_the_host_lu_cap(monkeypatch, diag):
    """Above ``_HOST_LU_MAX_N`` (100 here, in both packages): BiCGStab with
    a Jacobi preconditioner on the assembled operator, on the JAX test's
    matrix (a scrambled grid operator with 60 long-range couplings; its
    diagonal 4, and 8).

    BiCGStab amplifies the packages' rounding differences (their SpMVs and
    dots sum in other orders) on this matrix: with a diagonal of 8 both take
    12 iterations, but the residual grows over the first three (4.2 → 7.7)
    and x parts by 3.0e-8 relative; with the diagonal of 4 the JAX package
    takes 78 iterations, the port 71 (73 on a dense matvec), and x parts by
    8.3e-8.  So x is held to the solve's own accuracy (rtol 1e-8 with a
    small margin: rel-inf 1e-7; the residual, 2e-8 in both packages, to
    1e-7), the count exactly at diagonal 8 and at 4 within the measured
    span (the JAX package's 78, the port's 71 to 78).  BiCGStab's counts
    and x at 1e-10 on a system where it is stable:
    tests/test_torch_krylov_methods.py."""
    rng = np.random.default_rng(9)
    N = 24
    n = N * N
    d = np.ones(n)
    A = sp.diags([d * diag, -d[:-1], -d[:-1], -d[:-N], -d[:-N]],
                 [0, 1, -1, N, -N], format="lil")
    for _ in range(60):
        i, j = rng.integers(0, n, 2)
        A[i, j] = 0.1 * rng.standard_normal()
    sigma = rng.permutation(n)
    A = A.tocsr()[np.ix_(sigma, sigma)].tocsr()
    b = rng.standard_normal(n)
    monkeypatch.setattr(jds, "_HOST_LU_MAX_N", 100)
    monkeypatch.setattr(tds, "_HOST_LU_MAX_N", 100)
    iters = {}

    def spy(mod, key):
        orig = mod.bicgstab

        def run(*a, **kw):
            res = orig(*a, **kw)
            iters[key] = int(res.iterations)
            return res
        monkeypatch.setattr(mod, "bicgstab", run)

    spy(jkry, "jax")
    spy(tkry, "port")
    xj, okj, xt, okt = _direct(A, b, "iterative", jit=False)
    assert okj and okt
    np.testing.assert_allclose(A @ xt, b, rtol=0, atol=1e-7)
    assert _rel(xt, xj) <= 1e-7
    if diag == 8.0:
        assert iters["port"] == iters["jax"] == 12
    else:
        assert iters["jax"] == 78 and 71 <= iters["port"] <= 78

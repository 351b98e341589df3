"""The port's device-applied sparse LU (nonlinearsolve_tpu_torch/ops/
device_lu.py) against the JAX package's (tests/test_device_lu.py's inputs):
the plan (stage tags, row sets, tables, nnz(L), nnz(U), ``supported``) at
the Bratu pattern's 32² and 64², the schedule guards, the solve, the
refresh after new data, the plan cache keyed by dtype, the re-pivot and its
rebase, the preconditioner, and the two public routes end to end.

On the CPU every ELL stage and pre-gather runs K5's plain version: the
route the card runs with K5.

Tolerances: x rel-inf 1e-12 (f64; the factor is the same native LU, the
sweeps sum in another order); Newton solves: the same retcode and NLStats,
roots within 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu.ops.device_lu as jdl
import nonlinearsolve_tpu_torch as tnls
import nonlinearsolve_tpu_torch.ops.device_lu as tdl
from nonlinearsolve_tpu.models import bratu as jbratu
from nonlinearsolve_tpu.ops.krylov import gmres as jgmres
from nonlinearsolve_tpu.ops.sparse import CSR as JCSR
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.ops.krylov import gmres as tgmres
from nonlinearsolve_tpu_torch.ops.sparse import CSR as TCSR

torch.set_num_threads(2)

STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def _poisson_csr(N, seed=0):
    n = N * N
    d = np.ones(n)
    A = sp.diags([4 * d, -d[:-1], -d[:-1], -d[:-N], -d[:-N]],
                 [0, 1, -1, N, -N], format="csr")
    A.data = A.data * np.random.default_rng(seed).uniform(0.9, 1.1, A.nnz)
    return A


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def _plans(indptr, indices, n, **kw):
    return (jdl.DeviceLU(indptr, indices, n, dtype=jnp.float64, **kw),
            tdl.DeviceLU(indptr, indices, n, dtype=torch.float64, **kw))


@pytest.mark.parametrize("N", [32, 64])
def test_plan_equals_jax_on_the_bratu_pattern(N):
    pat = jbratu.sparsity_pattern(N)
    jlu, tlu = _plans(np.asarray(pat.indptr), np.asarray(pat.indices), N * N)
    assert jlu.supported and tlu.supported
    assert (tlu.nnzL, tlu.nnzU, tlu.epoch) == (jlu.nnzL, jlu.nnzU, jlu.epoch)
    for jst, tst, joff, toff in ((jlu.Lstages, tlu.Lstages, jlu._offL,
                                  tlu._offL),
                                 (jlu.Ustages, tlu.Ustages, jlu._offU,
                                  tlu._offU)):
        assert [s[0] for s in tst] == [s[0] for s in jst]
        assert toff == joff
        for j, t in zip(jst, tst):
            if j[0] == "ell":
                for a, b in zip(j[1:4], t[1:4]):
                    assert np.array_equal(a, b)
            else:
                for key in ("rows", "pre_cols", "pre_vmap", "dense_k"):
                    assert np.array_equal(j[1][key], t[1][key]), key
                assert j[1]["T"] == t[1]["T"]
                for a, b in zip(j[1]["dense_ij"], t[1]["dense_ij"]):
                    assert np.array_equal(a, b)
    for name in ("in_take", "lu_map", "out_take"):
        assert np.array_equal(np.asarray(getattr(jlu, name)),
                              getattr(tlu, "_" + name))
    summary = tlu.stage_summary()
    assert summary["L_stages"] + summary["U_stages"] == \
        len(jlu.Lstages) + len(jlu.Ustages)
    if N == 64:      # the plan the JAX package builds: 5 + 6, 4 ELL
        assert (summary["L_stages"], summary["U_stages"],
                summary["ell_stages"], tlu.nnzL) == (5, 6, 4, 104765)


@pytest.mark.parametrize("guard", ["levels", "padding"])
def test_schedule_guards_as_jax(monkeypatch, guard):
    """Too many stages (MAX_LEVELS 2 with no dense absorption) or too much
    ELL padding (PAD_RATIO_CAP 0): both packages refuse the plan."""
    for mod in (jdl, tdl):
        if guard == "levels":
            monkeypatch.setattr(mod, "MAX_LEVELS", 2)
            monkeypatch.setattr(mod, "DENSE_TAIL_MAX_LEVEL_ROWS", 0)
        else:
            monkeypatch.setattr(mod, "PAD_RATIO_CAP", 0.0)
            monkeypatch.setattr(mod, "DENSE_TAIL_MAX_LEVEL_ROWS", 0)
    A = _poisson_csr(8)
    jlu, tlu = _plans(A.indptr, A.indices, A.shape[0])
    assert not jlu.supported and not tlu.supported
    tdl._DEVICE_LU_CACHE.clear()
    assert tdl.device_lu_for(A.indptr, A.indices, 64) is None


def test_solve_and_refresh_match_jax():
    A = _poisson_csr(16)
    n = A.shape[0]
    jlu, tlu = _plans(A.indptr, A.indices, n)
    assert any(s[0] == "dense" for s in tlu.Lstages)
    assert any(s[0] == "dense" for s in tlu.Ustages)
    b = np.random.default_rng(1).standard_normal(n)
    A2 = A.copy()
    A2.data = A.data * np.random.default_rng(2).uniform(0.95, 1.05, A.nnz)
    for M in (A, A2):       # the second is a numeric-only refactorization
        xj, okj = jlu.solve(jlu.refresh_host(M.data), jnp.asarray(b))
        xt, okt = tlu.solve(tlu.refresh(torch.tensor(M.data)),
                            torch.tensor(b))
        assert bool(okj) and okt
        assert _rel(xt, xj) <= 1e-12
        assert _rel(xt, spla.spsolve(M.tocsc(), b)) <= 1e-12
    assert tlu.fac.n_refactor == jlu.fac.n_refactor >= 1
    # one refresh, any number of solves
    st = tlu.refresh_host(A2.data, device="cpu")
    x1, _ = tlu.solve(st, torch.tensor(b))
    x2, _ = tlu.solve(st, torch.tensor(2.0 * b))
    np.testing.assert_allclose(x2.numpy(), 2.0 * x1.numpy(), rtol=1e-12)


@pytest.mark.parametrize("N", [32, 64])
def test_solve_matches_jax_on_the_bratu_pattern(N):
    pat = jbratu.sparsity_pattern(N)
    ip, ix = np.asarray(pat.indptr), np.asarray(pat.indices)
    jlu, tlu = _plans(ip, ix, N * N)
    rng = np.random.default_rng(N)
    diag = ix == np.repeat(np.arange(N * N), np.diff(ip))
    data = rng.uniform(0.9, 1.1, len(ix)) * np.where(diag, -4.0, 1.0)
    b = rng.standard_normal(N * N)
    xj, _ = jlu.solve(jlu.refresh_host(data), jnp.asarray(b))
    xt, ok = tlu.solve(tlu.refresh_host(data, device="cpu"),
                       torch.tensor(b))
    assert ok and _rel(xt, xj) <= 1e-12


def test_cache_is_keyed_by_dtype():
    A = _poisson_csr(8, seed=11)
    n = A.shape[0]
    tdl._DEVICE_LU_CACHE.clear()
    lu32 = tdl.device_lu_for(A.indptr, A.indices, n, dtype=torch.float32)
    lu64 = tdl.device_lu_for(A.indptr, A.indices, n, dtype=torch.float64)
    assert lu32 is not lu64 and lu64.dtype == torch.float64
    assert tdl.device_lu_for(A.indptr, A.indices, n,
                             dtype=torch.float64) is lu64
    assert tdl.device_lu_for(A.indptr, A.indices, n) is lu32
    b = np.random.default_rng(12).standard_normal(n)
    x, ok = lu64.solve(lu64.refresh_host(A.data, device="cpu"),
                       torch.tensor(b))
    assert ok and _rel(x, spla.spsolve(A.tocsc(), b)) <= 1e-12
    x32, _ = lu32.solve(lu32.refresh_host(A.data, device="cpu"),
                        torch.tensor(b))
    assert x32.dtype == torch.float64                  # b's dtype
    assert _rel(x32, x) <= 1e-5                        # f32 sweeps


def test_repivot_falls_back_and_rebases(capsys):
    """A refresh whose data forces a re-pivot (the diagonal crushed): both
    packages report ok False and print the note; the port's solve leaves b
    as it is, and device_lu_for then rebuilds the plan from that data (the
    JAX package's rebase), which solves it."""
    A = _poisson_csr(8, seed=13)
    n = A.shape[0]
    A2 = A.copy()
    is_diag = A.indices == np.repeat(np.arange(n), np.diff(A.indptr))
    A2.data = np.where(is_diag, 1e-14, A.data)
    b = np.random.default_rng(14).standard_normal(n)
    jdl._DEVICE_LU_CACHE.clear()
    tdl._DEVICE_LU_CACHE.clear()
    jlu = jdl.device_lu_for(A.indptr, A.indices, n, dtype=jnp.float64)
    tlu = tdl.device_lu_for(A.indptr, A.indices, n, dtype=torch.float64)
    _, okj = jlu.solve(jlu.refresh_host(A2.data), jnp.asarray(b))
    xt, okt = tlu.solve(tlu.refresh_host(A2.data, device="cpu"),
                        torch.tensor(b))
    assert not bool(okj) and not okt and torch.equal(xt, torch.tensor(b))
    assert jlu.repivoted and tlu.repivoted
    err = capsys.readouterr().err
    assert err.count("precond_unavailable") == 2 and "re-pivoted" in err
    jlu2 = jdl.device_lu_for(A.indptr, A.indices, n, dtype=jnp.float64)
    tlu2 = tdl.device_lu_for(A.indptr, A.indices, n, dtype=torch.float64)
    assert tlu2 is not tlu and tlu2.supported
    xj, okj = jlu2.solve(jlu2.refresh_host(A2.data), jnp.asarray(b))
    xt, okt = tlu2.solve(tlu2.refresh_host(A2.data, device="cpu"),
                         torch.tensor(b))
    assert bool(okj) and okt and _rel(xt, xj) <= 1e-12


def test_preconditioner_collapses_gmres_as_jax():
    A = _poisson_csr(12, seed=5)
    n = A.shape[0]
    idx, ptr = np.asarray(A.indices, np.int32), np.asarray(A.indptr,
                                                           np.int32)
    jcsr = JCSR(jnp.asarray(A.data), idx, ptr, (n, n))
    tcsr = TCSR(torch.tensor(A.data), idx, ptr, (n, n))
    b = np.random.default_rng(6).standard_normal(n)
    jres = jgmres(jcsr.matvec_fn(), jnp.asarray(b), rtol=1e-10, restart=20,
                  M=jdl.device_lu_preconditioner(jcsr))
    tres = tgmres(tcsr.matvec_fn(), torch.tensor(b), rtol=1e-10, restart=20,
                  M=tdl.device_lu_preconditioner(tcsr))
    raw = tgmres(tcsr.matvec_fn(), torch.tensor(b), rtol=1e-10, restart=20)
    assert tres.success and tres.iterations == int(jres.iterations) <= 3
    assert tres.iterations < raw.iterations
    assert _rel(tres.x, jres.x) <= 1e-10


def _poisson_problem(mod, lib, A, b):
    """tests/test_device_lu.py's mildly nonlinear Poisson system, its CSR
    pattern as the Jacobian prototype."""
    n = A.shape[0]
    idx, ptr = np.asarray(A.indices, np.int32), np.asarray(A.indptr,
                                                           np.int32)
    if lib is torch:
        Ad, bb = torch.tensor(A.toarray()), torch.tensor(b)
        proto = TCSR(torch.tensor(A.data), idx, ptr, (n, n))
        u0 = torch.zeros(n, dtype=torch.float64)
    else:
        Ad, bb = jnp.asarray(A.toarray()), jnp.asarray(b)
        proto = JCSR(jnp.asarray(A.data), idx, ptr, (n, n))
        u0 = jnp.zeros(n)

    def f(u, p):
        return Ad @ u + 0.05 * u ** 3 - p

    return mod.NonlinearProblem(mod.NonlinearFunction(f, jac_prototype=proto),
                                u0, bb)


@pytest.mark.parametrize("ls", [dict(method="sparse_lu_device"),
                                dict(method="gmres", precond="device_lu")])
def test_public_routes_match_jax(ls):
    """NewtonRaphson with the device-applied LU as the linear solver, and
    as GMRES's preconditioner (with a sparse-AD Jacobian: the JAX package's
    GMRES with mode 'auto' takes the matrix-free operator, where no plan
    applies)."""
    A = _poisson_csr(12, seed=9)
    b = np.random.default_rng(10).standard_normal(A.shape[0])
    jdl._DEVICE_LU_CACHE.clear()
    jsol = jnls.solve(_poisson_problem(jnls, jnp, A, b), jnls.NewtonRaphson(
        autodiff=jnls.JacobianPolicy(mode="sparse"),
        linsolve=jnls.LinearSolver(**ls)), abstol=1e-10)
    _backend.reset_counters()
    tsol = tnls.solve(_poisson_problem(tnls, torch, A, b), tnls.NewtonRaphson(
        autodiff=tnls.JacobianPolicy(mode="sparse"),
        linsolve=tnls.LinearSolver(**ls)), abstol=1e-10)
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert {k: int(getattr(tsol.stats, k)) for k in STATS} == \
        {k: int(getattr(jsol.stats, k)) for k in STATS}
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-10)
    assert _backend.ROUTES["device_lu"] >= tsol.stats.nsolve


def test_two_solves_in_a_row_succeed_in_the_port():
    """The JAX package's device-LU plan is built inside its first solve's
    trace and cached, so its second solve on the pattern raises
    UnexpectedTracerError; the port's cache serves every later solve."""
    from nonlinearsolve_tpu_torch.models import bratu as tbratu
    N = 16
    jalg = jnls.NewtonRaphson(autodiff=jnls.JacobianPolicy(mode="sparse"),
                              linsolve=jnls.LinearSolver(
                                  method="sparse_lu_device"))
    jdl._DEVICE_LU_CACHE.clear()
    jsol = jnls.solve(jbratu.make_problem(N), jalg, abstol=1e-10)
    with pytest.raises(jax.errors.UnexpectedTracerError):
        jnls.solve(jbratu.make_problem(N), jalg, abstol=1e-10)
    jdl._DEVICE_LU_CACHE.clear()
    talg = tnls.NewtonRaphson(autodiff=tnls.JacobianPolicy(mode="sparse"),
                              linsolve=tnls.LinearSolver(
                                  method="sparse_lu_device"))
    tdl._DEVICE_LU_CACHE.clear()
    for _ in range(2):
        syncs = _backend.HOST_SYNCS["n"]
        tsol = tnls.solve(tbratu.make_problem(N, device="cpu"), talg,
                          abstol=1e-10)
        assert int(tsol.retcode) == int(jsol.retcode) == 1
        assert tsol.stats.nsteps == int(jsol.stats.nsteps)
        np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                                   rtol=0, atol=1e-10)
        # a refresh a step reads J once, besides the engine's reads
        assert _backend.HOST_SYNCS["n"] - syncs >= tsol.stats.njacs
    assert len(tdl._DEVICE_LU_CACHE) == 1

"""The assembled sparse path end to end: Newton, GMRES(8) with the FFT
Poisson preconditioner and Eisenstat–Walker η = 0.1 on a colored sparse-AD
Jacobian of the flat Brusselator (f64), the port against the JAX package
on the same numpy problem data.

- The DIA route (the route the card takes): the port takes it on any
  device; the JAX package takes it off the TPU only behind its test hook
  ``core.jacobian._FORCE_DIA_JAC``.  N=16 and N=32, abstol 1e-8: the same
  retcode and NLStats, roots within 1e-10.
- The CSR route: the same Brusselator with its unknowns permuted by a
  seeded permutation (far more than 48 generalised diagonals, so the DIA
  tier refuses it) and the preconditioner conjugated by the permutation,
  against the JAX package's CPU default (CSR).  Its root, permuted back,
  is the DIA route's.
- The refusal of a shaped state with a sparse Jacobian and GMRES (the JAX
  package fails there too); the sparse direct route (ROADMAP A.23) on the
  same flat problem.
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu.core.jacobian as jjac
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.ops.preconditioners import \
    fft_poisson_preconditioner as jfft
from nonlinearsolve_tpu.solvers.first_order import \
    EisenstatWalkerForcing as JEW
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.core import solve as tsolve
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.ops.preconditioners import \
    fft_poisson_preconditioner as tfft

torch.set_num_threads(2)

STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def _fft_kw(N):
    return dict(alpha=10.0, h=1.0 / (N - 1), shift=3.0, n_components=2)


def _algs(N, perm=None, **ls):
    """JAX and port NewtonRaphson with sparse AD, GMRES(8), the FFT
    preconditioner (conjugated by ``perm`` when given) and η = 0.1."""
    jM, tM = jfft((N, N), **_fft_kw(N)), tfft((N, N), **_fft_kw(N))
    if perm is not None:
        pinv = np.argsort(perm)
        jperm, jpinv = jnp.asarray(perm), jnp.asarray(pinv)
        tperm, tpinv = torch.as_tensor(perm), torch.as_tensor(pinv)
        jM = (lambda v, M=jM: M(v[jpinv])[jperm])
        tM = (lambda v, M=tM: M(v[tpinv])[tperm])
    kw = dict(method="gmres", restart=8, krylov_maxiter=100)
    kw.update(ls)
    jalg = jnls.NewtonRaphson(
        autodiff=jnls.JacobianPolicy(mode="sparse"),
        linsolve=jnls.LinearSolver(precond_fn=jM, **kw),
        forcing=JEW(eta_0=0.1, eta_max=0.1))
    talg = tnls.NewtonRaphson(
        autodiff=tnls.JacobianPolicy(mode="sparse"),
        linsolve=tnls.LinearSolver(precond_fn=tM, **kw),
        forcing=tnls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    return jalg, talg


def _problems(N, perm=None):
    """The flat Brusselator (optionally with permuted unknowns:
    w = u[perm], G(w) = F(w[pinv])[perm]) in both packages."""
    u0 = np.asarray(jbru.init_u0(N)).reshape(-1)
    p = np.asarray(jbru.default_p(N))
    pat = jbru.sparsity_pattern(N)
    if perm is None:
        jsp, tsp = pat, tbru.sparsity_pattern(N)
        pinv = None
    else:
        pinv = np.argsort(perm)
        coo = (pinv[pat.row_ids], pinv[pat.indices])
        jsp = tsp = coo
        u0 = u0[perm]

    def jf(u, p_):
        x = u if pinv is None else u[jnp.asarray(pinv)]
        r = jbru.brusselator_2d(x.reshape(N, N, 2), p_).reshape(-1)
        return r if perm is None else r[jnp.asarray(perm)]

    def tf(u, p_):
        x = u if pinv is None else u[torch.as_tensor(pinv)]
        r = tbru.brusselator_2d(x.reshape(N, N, 2), p_).reshape(-1)
        return r if perm is None else r[torch.as_tensor(perm)]

    jprob = jnls.NonlinearProblem(jnls.NonlinearFunction(f=jf, sparsity=jsp),
                                  jnp.asarray(u0), jnp.asarray(p))
    tprob = tnls.NonlinearProblem(tnls.NonlinearFunction(f=tf, sparsity=tsp),
                                  torch.tensor(u0), torch.tensor(p))
    return jprob, tprob


def _check_equal(jsol, tsol, root_atol=1e-10):
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert {k: int(getattr(tsol.stats, k)) for k in STATS} == \
        {k: int(getattr(jsol.stats, k)) for k in STATS}
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=root_atol)


@pytest.mark.parametrize("N", [16, 32])
def test_dia_route_matches_jax(N, monkeypatch):
    monkeypatch.setattr(jjac, "_FORCE_DIA_JAC", True)
    jprob, tprob = _problems(N)
    jalg, talg = _algs(N)
    jsol = jnls.solve(jprob, jalg, abstol=1e-8, maxiters=30)
    before = dict(_backend.LAUNCHES)
    tsol = tnls.solve(tprob, talg, abstol=1e-8, maxiters=30)
    _check_equal(jsol, tsol)
    assert float(tsol.resid.abs().max()) <= 1e-8
    assert _backend.LAUNCHES == before          # plain versions on the CPU
    assert tsol.counters["jvp"] >= tsol.counters["krylov_iters"] > 0
    plan, = tsolve._SPARSE_PLANS[tprob.f].values()
    assert plan.n_colors == 8 and plan.dia_plan.ndiag == 11


def test_csr_route_matches_jax():
    N = 16
    perm = np.random.default_rng(42).permutation(2 * N * N)
    jprob, tprob = _problems(N, perm)
    jalg, talg = _algs(N, perm)
    jsol = jnls.solve(jprob, jalg, abstol=1e-8, maxiters=30)
    tsol = tnls.solve(tprob, talg, abstol=1e-8, maxiters=30)
    _check_equal(jsol, tsol)
    plan, = tsolve._SPARSE_PLANS[tprob.f].values()
    assert plan.dia_plan is None                 # the CSR tier (K5)
    # permuted back, the root is the DIA route's
    _, tprob0 = _problems(N)
    root = tnls.solve(tprob0, _algs(N)[1], abstol=1e-8, maxiters=30).u
    np.testing.assert_allclose(tsol.u.numpy()[np.argsort(perm)],
                               root.numpy(), rtol=0, atol=1e-9)


def test_jacobi_precond_on_dia_matches_jax(monkeypatch):
    """The built-in Jacobi preconditioner on the DIA Jacobian."""
    monkeypatch.setattr(jjac, "_FORCE_DIA_JAC", True)
    N = 8
    jprob, tprob = _problems(N)
    kw = dict(method="gmres", restart=30, precond="jacobi")
    jalg = jnls.NewtonRaphson(autodiff=jnls.JacobianPolicy(mode="sparse"),
                              linsolve=jnls.LinearSolver(**kw))
    talg = tnls.NewtonRaphson(autodiff=tnls.JacobianPolicy(mode="sparse"),
                              linsolve=tnls.LinearSolver(**kw))
    jsol = jnls.solve(jprob, jalg, abstol=1e-8, maxiters=30)
    tsol = tnls.solve(tprob, talg, abstol=1e-8, maxiters=30)
    _check_equal(jsol, tsol, root_atol=1e-9)


def test_plan_is_built_once_per_function():
    N = 8
    _, tprob = _problems(N)
    _, talg = _algs(N)
    tnls.solve(tprob, talg, abstol=1e-8, maxiters=30)
    plans = tsolve._SPARSE_PLANS[tprob.f]
    plan, = plans.values()
    tnls.solve(tprob, talg, abstol=1e-8, maxiters=30)
    assert tsolve._SPARSE_PLANS[tprob.f] is plans
    assert list(plans.values()) == [plan]


def test_plan_goes_with_its_function():
    """The plan cache holds no function alive: a problem built anew for
    each solve does not pile up plans (and their device tables)."""
    N = 8
    _, talg = _algs(N)
    _, tprob = _problems(N)
    tnls.solve(tprob, talg, abstol=1e-8, maxiters=30)
    ref = weakref.ref(tprob.f)
    assert ref() in tsolve._SPARSE_PLANS
    del tprob
    gc.collect()
    assert ref() is None


def test_shaped_state_with_sparse_krylov_raises():
    """make_problem(with_sparsity=True) is shaped (N, N, 2), as in the JAX
    package, whose sparse Krylov path fails on it; the port refuses it."""
    N = 8
    prob = tbru.make_problem(N, device="cpu", with_sparsity=True)
    assert prob.f.sparsity.shape == (2 * N * N, 2 * N * N)
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        tnls.solve(prob, _algs(N)[1], abstol=1e-8)


@pytest.mark.parametrize("mode", ["sparse", "auto"])
def test_sparse_direct_route_names_a23(mode):
    """The sparse direct route (ROADMAP A.23), refused until it was ported:
    with the default linear solver the flat Brusselator's periodic pattern
    at N=8 takes RCM + block cyclic reduction, in both packages, with the
    same retcode and NLStats and roots within 1e-10."""
    N = 8
    jprob, tprob = _problems(N)
    jsol = jnls.solve(jprob, jnls.NewtonRaphson(
        autodiff=jnls.JacobianPolicy(mode=mode)), abstol=1e-8)
    _backend.reset_counters()
    tsol = tnls.solve(tprob, tnls.NewtonRaphson(
        autodiff=tnls.JacobianPolicy(mode=mode)), abstol=1e-8)
    _check_equal(jsol, tsol)
    assert _backend.ROUTES["rcm_bcr"] == tsol.stats.nsolve > 0
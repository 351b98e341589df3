"""The slice as a whole: matrix-free Newton–GMRES–FFT on the Brusselator,
the port (plain K1 on the CPU) against the JAX package (Pallas K1 in
interpret mode), both fed the same numpy problem data through
``nonlinearsolve_tpu_torch.interop``.

- N=16 f64, restart 30, abstol 1e-10: retcode (Success) and NLStats
  equal, u atol 1e-8.
- the bench's algorithm (restart 8, η = 0.1) at N=32 f32: retcode and
  NLStats equal.  abstol is 0.05, twice the f32 floor at this size
  (|F| ≈ 0.025 at the f64 root rounded to f32; the JAX package reaches
  MaxIters at 1e-3).  Both f32 roots are inexact-Newton roots at η = 0.1,
  each about 2e-4 (rel-inf) from the f64 root, so they are held to 5e-4 of
  each other and of the f64 root.
- N=12 f64 against scipy's ``optimize.root(method="krylov")``, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import optimize

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.ops.preconditioners import \
    fft_poisson_preconditioner as jfft
from nonlinearsolve_tpu.solvers.first_order import \
    EisenstatWalkerForcing as JEW
from nonlinearsolve_tpu_torch import interop
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.ops.preconditioners import \
    fft_poisson_preconditioner as tfft

torch.set_num_threads(2)


def _algs(N, restart, eta=None, krylov_maxiter=None):
    kw = dict(alpha=10.0, h=1.0 / (N - 1), shift=3.0, n_components=2)
    jalg = jnls.NewtonRaphson(
        linsolve=jnls.LinearSolver(method="gmres", restart=restart,
                                   krylov_maxiter=krylov_maxiter,
                                   precond_fn=jfft((N, N), **kw)),
        forcing=None if eta is None else JEW(eta_0=eta, eta_max=eta))
    talg = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=restart,
                                   krylov_maxiter=krylov_maxiter,
                                   precond_fn=tfft((N, N), **kw)),
        forcing=(None if eta is None
                 else tnls.EisenstatWalkerForcing(eta_0=eta, eta_max=eta)))
    return jalg, talg


def _jax_stats(sol):
    return {k: int(getattr(sol.stats, k))
            for k in ("nf", "njacs", "nfactors", "nsolve", "nsteps")}


def _solve_both(N, dtype, restart, abstol, eta=None, maxiters=1000,
                krylov_maxiter=None):
    jprob = jbru.make_problem(N, dtype, pallas_jvp=True)
    jalg, talg = _algs(N, restart, eta, krylov_maxiter)
    jsol = jnls.solve(jprob, jalg, abstol=abstol, maxiters=maxiters)
    tprob = interop.problem_from_numpy(np.asarray(jprob.u0),
                                       np.asarray(jprob.p), kernel_jvp=True,
                                       device="cpu")
    tsol = tnls.solve(tprob, talg, abstol=abstol, maxiters=maxiters)
    return jsol, interop.solution_to_numpy(tsol), tsol


def _f64_root(N):
    jalg, _ = _algs(N, 30)
    sol = jnls.solve(jbru.make_problem(N, jnp.float64, pallas_jvp=True),
                     jalg, abstol=1e-10)
    assert int(sol.retcode) == 1
    return np.asarray(sol.u)


def test_newton_gmres_fft_matches_jax_f64():
    jsol, out, tsol = _solve_both(16, jnp.float64, restart=30, abstol=1e-10)
    assert out["retcode"] == int(jsol.retcode) == 1
    assert out["stats"] == _jax_stats(jsol)
    np.testing.assert_allclose(out["u"], np.asarray(jsol.u), rtol=0,
                               atol=1e-8)
    assert np.abs(out["resid"]).max() <= 1e-10
    # every Jacobian product went through the analytic (kernel) jvp, and
    # each Krylov iteration made exactly one
    assert tsol.counters["jvp"] == tsol.counters["krylov_iters"] > 0
    assert tsol.counters["host_syncs"] > 0


def test_bench_algorithm_matches_jax_f32():
    N = 32
    jsol, out, _ = _solve_both(N, jnp.float32, restart=8, abstol=0.05,
                               eta=0.1, maxiters=30, krylov_maxiter=100)
    assert out["retcode"] == int(jsol.retcode) == 1
    assert out["stats"] == _jax_stats(jsol)
    assert out["u"].dtype == np.float32
    u64 = _f64_root(N)
    scale = np.abs(u64).max()
    ju = np.asarray(jsol.u, np.float64)
    assert np.abs(out["u"] - ju).max() <= 5e-4 * scale
    assert np.abs(out["u"] - u64).max() <= 5e-4 * scale
    assert np.abs(ju - u64).max() <= 5e-4 * scale


def test_autodiff_operator_matches_kernel_jvp():
    """Without the analytic jvp the operator differentiates the residual
    with torch.func.jvp; the solve is the same."""
    N = 16
    _, talg = _algs(N, 30)
    with_k = tnls.solve(tbru.make_problem(N, kernel_jvp=True, device="cpu"),
                        talg, abstol=1e-10)
    with_ad = tnls.solve(tbru.make_problem(N, kernel_jvp=False,
                                           device="cpu"), talg, abstol=1e-10)
    assert with_k.retcode == with_ad.retcode == tnls.ReturnCode.Success
    assert with_k.stats == with_ad.stats
    np.testing.assert_allclose(with_ad.u.numpy(), with_k.u.numpy(),
                               rtol=0, atol=1e-10)


def test_matches_scipy_krylov_root():
    N = 12
    prob = tbru.make_problem(N, torch.float64, kernel_jvp=True, device="cpu")
    _, talg = _algs(N, 30)
    sol = tnls.solve(prob, talg, abstol=1e-10)
    assert sol.success

    def fn(x):
        U = torch.tensor(x.reshape(N, N, 2))
        return tbru.brusselator_2d(U, prob.p).numpy().ravel()

    res = optimize.root(fn, prob.u0.numpy().ravel(), method="krylov",
                        options={"fatol": 1e-10})
    assert res.success, res.message
    np.testing.assert_allclose(sol.u.numpy().ravel(), res.x, atol=1e-6)


@pytest.mark.parametrize("maxiters", [0, 1, 2])
def test_maxiters_and_safe_best_match_jax(maxiters):
    """MaxIters and the safe-best iterate's re-evaluation (nf + 1)."""
    jsol, out, _ = _solve_both(16, jnp.float64, restart=30, abstol=1e-10,
                               maxiters=maxiters)
    assert out["retcode"] == int(jsol.retcode) == 3
    assert out["stats"] == _jax_stats(jsol)
    np.testing.assert_allclose(out["u"], np.asarray(jsol.u), rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("eta_0,eta_max", [(0.01, 0.1), (0.1, 0.5)])
def test_forcing_sequence_matches_jax(eta_0, eta_max):
    """Eisenstat–Walker with the default γ, α and safeguard (f64): η moves
    with the residual's contraction between η₀ and η_max."""
    N = 16
    jprob = jbru.make_problem(N, jnp.float64, pallas_jvp=True)
    kw = dict(alpha=10.0, h=1.0 / (N - 1), shift=3.0, n_components=2)
    jalg = jnls.NewtonRaphson(linsolve=jnls.LinearSolver(
        method="gmres", restart=10, precond_fn=jfft((N, N), **kw)),
        forcing=JEW(eta_0=eta_0, eta_max=eta_max))
    talg = tnls.NewtonRaphson(linsolve=tnls.LinearSolver(
        method="gmres", restart=10, precond_fn=tfft((N, N), **kw)),
        forcing=tnls.EisenstatWalkerForcing(eta_0=eta_0, eta_max=eta_max))
    jsol = jnls.solve(jprob, jalg, abstol=1e-9, maxiters=50)
    tsol = tnls.solve(interop.problem_from_numpy(
        np.asarray(jprob.u0), np.asarray(jprob.p), device="cpu"), talg,
        abstol=1e-9, maxiters=50)
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert interop.solution_to_numpy(tsol)["stats"] == _jax_stats(jsol)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-8)


def test_linear_solve_failure_retcode():
    """A non-finite Jacobian product fails the linear solve:
    InternalLinearSolveFailed, as in the JAX package."""
    N = 8
    prob = tbru.make_problem(N, device="cpu")
    bad = tnls.NonlinearProblem(
        tnls.NonlinearFunction(f=prob.f.f,
                               jvp=lambda v, u, p: v * float("nan")),
        prob.u0, prob.p)
    alg = tnls.NewtonRaphson(linsolve=tnls.LinearSolver(method="gmres"))
    sol = tnls.solve(bad, alg, abstol=1e-10)
    assert sol.retcode == tnls.ReturnCode.InternalLinearSolveFailed
    assert sol.stats.nsteps == 1
    np.testing.assert_array_equal(sol.u.numpy(), prob.u0.numpy())


@pytest.mark.parametrize("sparse", [False, True])
def test_empty_state_matches_jax(sparse):
    """An empty f64 state takes the null-u0 fast path: Success, u = resid =
    u0 and zero NLStats, as the JAX package's ``_build_null_solution``; no
    sparse plan is built for it."""
    from nonlinearsolve_tpu_torch.core import solve as solve_mod

    def f(u, p):
        return u ** 3 - 1

    empty = (np.zeros(0, np.int64), np.zeros(0, np.int64))
    jkw = tkw = {}
    if sparse:
        jkw = {"autodiff": jnls.JacobianPolicy(mode="sparse")}
        tkw = {"autodiff": tnls.JacobianPolicy(mode="sparse")}
    jsol = jnls.solve(
        jnls.NonlinearProblem(jnls.NonlinearFunction(f, sparsity=empty),
                              jnp.ones(0, jnp.float64)),
        jnls.NewtonRaphson(linsolve=jnls.LinearSolver("gmres"), **jkw))
    tfun = tnls.NonlinearFunction(f, sparsity=empty)
    tsol = tnls.solve(
        tnls.NonlinearProblem(tfun, torch.ones(0, dtype=torch.float64)),
        tnls.NewtonRaphson(linsolve=tnls.LinearSolver("gmres"), **tkw))
    out = interop.solution_to_numpy(tsol)
    assert out["retcode"] == int(jsol.retcode) == int(tnls.ReturnCode.Success)
    assert out["stats"] == _jax_stats(jsol) == dict.fromkeys(
        ("nf", "njacs", "nfactors", "nsolve", "nsteps"), 0)
    for key in ("u", "resid"):
        ref = np.asarray(getattr(jsol, key))
        assert out[key].shape == ref.shape == (0,)
        assert out[key].dtype == ref.dtype == np.float64
    assert tsol.counters == {"jvp": 0, "krylov_iters": 0, "host_syncs": 0}
    assert tfun not in solve_mod._SPARSE_PLANS


def test_jax_and_port_take_the_same_numpy_state():
    N = 16
    jprob = jbru.make_problem(N, jnp.float32)
    tprob = interop.problem_from_numpy(np.asarray(jprob.u0),
                                       np.asarray(jprob.p), device="cpu")
    assert tprob.u0.dtype == torch.float32 and tprob.p.dtype == torch.float32
    np.testing.assert_array_equal(tprob.u0.numpy(), np.asarray(jprob.u0))
    np.testing.assert_array_equal(
        tprob.u0.numpy(),
        tbru.make_problem(N, torch.float32, device="cpu").u0.numpy())
    jax.block_until_ready(jprob.u0)

"""The 3D reaction–diffusion slice of the port against the JAX package, on
the CPU: the model (forcing, residual, the kernel jvp of ``make_problem``),
the 3D FFT Poisson preconditioner, the interop builder, the profiling
helpers, and the whole Newton–GMRES–FFT solve at the example's operating
point (``examples/07_3d_reaction_diffusion_tpu.py``: GMRES(8),
krylov_maxiter 200, shift −0.9, η₀ = η_max = 0.1, abstol 1e-5·N,
maxiters 30).

Tolerances: the forcing bit for bit (the same numpy formula); residual and
jvp f64 rtol 1e-12 of max|F| (the same operations), f32 1e-6; the
preconditioner f64 rtol 1e-12 (the FFT libraries differ); the solves: the
same retcode and NLStats, roots within rel-inf 1e-8 (f64) and 1e-4 (f32,
where GMRES sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models import reaction_diffusion as jrd
from nonlinearsolve_tpu.ops.preconditioners import \
    fft_poisson_preconditioner as jfft
from nonlinearsolve_tpu.solvers.first_order import \
    EisenstatWalkerForcing as JEW
from nonlinearsolve_tpu.utils import profiling as jprof
from nonlinearsolve_tpu_torch import _backend, interop
from nonlinearsolve_tpu_torch.models import reaction_diffusion as trd
from nonlinearsolve_tpu_torch.ops.preconditioners import \
    fft_poisson_preconditioner as tfft
from nonlinearsolve_tpu_torch.utils import profiling as tprof

torch.set_num_threads(2)

JNP = {"float32": jnp.float32, "float64": jnp.float64}
TORCH = {"float32": torch.float32, "float64": torch.float64}
RTOL = {"float64": 1e-12, "float32": 1e-6}
D = 0.01


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N", [16, 17])
def test_forcing_is_bit_equal_to_jax(N, dtype):
    got = trd.forcing(N, TORCH[dtype], device="cpu")
    assert got.dtype == TORCH[dtype] and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jrd.forcing(N, JNP[dtype])))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_residual_matches_jax(dtype):
    N = 16
    u = (0.1 + 0.5 * np.random.default_rng(3).standard_normal((N, N, N))
         ).astype(np.dtype(dtype))
    jp = (jnp.asarray(D, JNP[dtype]), jrd.forcing(N, JNP[dtype]))
    ref = np.asarray(jrd.reaction_diffusion_3d(jnp.asarray(u), jp))
    tp = (torch.tensor(D, dtype=TORCH[dtype]),
          trd.forcing(N, TORCH[dtype], device="cpu"))
    got = trd.reaction_diffusion_3d(torch.tensor(u), tp).numpy()
    assert got.dtype == np.dtype(dtype)
    scale = np.abs(ref).max()
    assert np.abs(got.astype(np.float64) - ref).max() <= RTOL[dtype] * scale


@pytest.fixture(scope="module")
def jax_jvp_case():
    """(u0, u, v, J(u)·v) of the JAX package's 16³ f64 problem with its
    Pallas jvp (interpret mode), computed once."""
    N = 16
    jprob = jrd.make_problem(N, dtype=jnp.float64, pallas_jvp=True)
    rng = np.random.default_rng(4)
    u = 0.1 + 0.5 * rng.standard_normal((N, N, N))
    v = rng.standard_normal((N, N, N))
    ref = np.asarray(jprob.f.jvp(jnp.asarray(v), jnp.asarray(u), jprob.p))
    return np.asarray(jprob.u0), u, v, ref


@pytest.mark.parametrize("kernel_jvp", [True, False])
def test_make_problem_jvp_matches_jax(kernel_jvp, jax_jvp_case):
    """``make_problem(kernel_jvp=True)``'s jvp (plain K9 on the CPU) and the
    ``torch.func.jvp`` route against the JAX package's Pallas jvp, f64."""
    u0, u, v, ref = jax_jvp_case
    tprob = trd.make_problem(16, kernel_jvp=kernel_jvp, device="cpu")
    np.testing.assert_array_equal(tprob.u0.numpy(), u0)
    assert (tprob.f.jvp is not None) == kernel_jvp
    U, V = torch.tensor(u), torch.tensor(v)
    if kernel_jvp:
        got = tprob.f.jvp(V, U, tprob.p)
    else:
        got = torch.func.jvp(lambda x: trd.reaction_diffusion_3d(x, tprob.p),
                             (U,), (V,))[1]
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_make_problem_refuses_bz_not_dividing_n():
    with pytest.raises(ValueError, match="bz"):
        trd.make_problem(10, kernel_jvp=True, device="cpu")
    with pytest.raises(ValueError, match="bz"):
        trd.make_problem(16, kernel_jvp=True, bz=3, device="cpu")
    with pytest.raises(ValueError, match="bz"):
        jrd.make_problem(10, pallas_jvp=True)
    assert trd.make_problem(10, device="cpu").f.jvp is None


def test_make_problem_device_policy():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trd.make_problem(8)
    with pytest.raises(RuntimeError):
        trd.forcing(8)


@pytest.mark.parametrize("shaped", [True, False])
def test_3d_preconditioner_matches_jax(shaped):
    """The rfft route (one component, negative shift) on an N³ grid."""
    N = 16
    v = np.random.default_rng(6).standard_normal((N, N, N))
    if not shaped:
        v = v.reshape(-1)
    ref = np.asarray(jfft((N, N, N), D, 1.0 / N, shift=-0.9)(jnp.asarray(v)))
    got = tfft((N, N, N), D, 1.0 / N, shift=-0.9)(torch.tensor(v))
    assert tuple(got.shape) == v.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_interop_builds_the_same_problem(dtype):
    N = 16
    jprob = jrd.make_problem(N, dtype=jnp.float64)
    tprob = interop.reaction_diffusion_problem_from_numpy(
        np.asarray(jprob.u0), np.asarray(jprob.p[0]), np.asarray(jprob.p[1]),
        kernel_jvp=True, device="cpu", dtype=dtype)
    want = trd.make_problem(N, dtype=dtype or torch.float64, kernel_jvp=True,
                            device="cpu")
    assert tprob.u0.dtype == want.u0.dtype
    np.testing.assert_array_equal(tprob.u0.numpy(), want.u0.numpy())
    assert tprob.p[0].dim() == 0 and tprob.p[0].dtype == want.u0.dtype
    for a, b in zip(tprob.p, want.p):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert tprob.f.jvp is not None


def _fake_clock(monkeypatch, module, durations):
    """Make ``module.time.perf_counter`` a clock that each run call
    advances by the next of ``durations``."""
    now = {"t": 0.0}
    steps = iter(durations)

    class _Clock:
        @staticmethod
        def perf_counter():
            return now["t"]

    monkeypatch.setattr(module, "time", _Clock)
    return lambda: now.__setitem__("t", now["t"] + next(steps))


def test_slope_time_matches_jax_on_fixed_timings(monkeypatch):
    # (short, long) per round: slopes 0.4, 0.1, 0.25, -1.0, 0.3 per unit
    durs = [1.0, 3.0, 2.0, 2.5, 1.0, 2.25, 5.0, 0.0, 1.0, 2.5]
    for module in (tprof, jprof):
        tick = _fake_clock(monkeypatch, module, list(durs))
        got = module.slope_time(tick, tick, span=5, rounds=5)
        assert got == pytest.approx(0.25)
    tick = _fake_clock(monkeypatch, tprof, [2.0, 1.0])
    assert tprof.slope_time(tick, tick, span=1, rounds=1) == 0.0


def test_chained_solve_time_and_profile_solve_on_cpu():
    N = 8
    prob = trd.make_problem(N, kernel_jvp=True, device="cpu")
    alg = tnls.NewtonRaphson(linsolve=tnls.LinearSolver(
        method="gmres", restart=8,
        precond_fn=tfft((N, N, N), D, 1.0 / N, shift=-0.9)))
    t = tprof.chained_solve_time(prob, alg, k=2, reps=1, abstol=1e-8)
    assert np.isfinite(t) and t >= 0.0
    with pytest.raises(ValueError):
        tprof.chained_solve_time(prob, alg, k=1)
    sol, prof = tprof.profile_solve(prob, alg, abstol=1e-8)
    assert sol.retcode == tnls.ReturnCode.Success
    assert any("roll" in ev.key for ev in prof.key_averages())


def _example_algs(N):
    h = 1.0 / N
    jalg = jnls.NewtonRaphson(
        linsolve=jnls.LinearSolver(method="gmres", restart=8,
                                   krylov_maxiter=200,
                                   precond_fn=jfft((N, N, N), D, h,
                                                   shift=-0.9)),
        forcing=JEW(eta_0=0.1, eta_max=0.1))
    talg = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=8,
                                   krylov_maxiter=200,
                                   precond_fn=tfft((N, N, N), D, h,
                                                   shift=-0.9)),
        forcing=tnls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    return jalg, talg


@pytest.mark.parametrize("N,dtype,tol", [(16, "float64", 1e-8),
                                         (32, "float32", 1e-4)])
def test_example_solve_matches_jax(N, dtype, tol):
    """The example's solve: the JAX package with its Pallas jvp (interpret
    mode) against the port with kernel_jvp (plain K9), from the same numpy
    problem data: 6 Newton steps, nf 8, njacs 6, in both."""
    jprob = jrd.make_problem(N, dtype=JNP[dtype], pallas_jvp=True)
    jalg, talg = _example_algs(N)
    abstol = 1e-5 * N
    jsol = jnls.solve(jprob, jalg, abstol=abstol, maxiters=30)
    tprob = interop.reaction_diffusion_problem_from_numpy(
        np.asarray(jprob.u0), np.asarray(jprob.p[0]), np.asarray(jprob.p[1]),
        kernel_jvp=True, device="cpu")
    before = dict(_backend.LAUNCHES)
    tsol = tnls.solve(tprob, talg, abstol=abstol, maxiters=30)
    assert _backend.LAUNCHES == before
    out = interop.solution_to_numpy(tsol)
    assert out["retcode"] == int(jsol.retcode) == 1
    assert out["stats"] == {k: int(getattr(jsol.stats, k)) for k in
                            ("nf", "njacs", "nfactors", "nsolve", "nsteps")}
    assert (out["stats"]["nsteps"], out["stats"]["nf"],
            out["stats"]["njacs"]) == (6, 8, 6)
    assert out["u"].dtype == np.dtype(dtype)
    assert np.abs(out["resid"]).max() <= abstol
    ju = np.asarray(jsol.u, np.float64)
    assert np.abs(out["u"] - ju).max() <= tol * np.abs(ju).max()
    # every GMRES iteration made one Jacobian product, through K9's jvp
    assert tsol.counters["jvp"] == tsol.counters["krylov_iters"] > 0
    jax.clear_caches()

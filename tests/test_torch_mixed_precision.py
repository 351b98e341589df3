"""The bf16 path of the port on the CPU against the JAX package: K3
(``make_brusselator_jvp_bf16``; the port's plain version, which the wrapper
takes for CPU tensors, against the JAX kernel in interpret mode), the
narrowed GMRES basis (``gmres(basis_dtype=)``,
``LinearSolver(krylov_basis_dtype=)``) and the flagship's two bf16 runs at
N=32, on the same seeded numpy inputs.

Tolerances:
- K3: the port's plain bf16 matvec and the JAX one agree bit for bit at
  N = 16, 32 and 64 on four seeds (measured: 0 differing values of 2,048
  at N=32), so the bound is 0; each is held to the f32 JVP at the JAX
  test's rel-norm 2e-2 (measured 3.3e-3 to 4.2e-3).
- The bf16 basis on ``tests/test_sparse_krylov.py``'s system: success, at
  most 5 more iterations than the JAX package's bf16 run, rel 2e-2 to the
  direct solve — that test's bounds.
- The flagship's runs at N=32 f32 (bench.py's operating point): retcode
  equal, nsteps within 1.  Run (a), the bf16 basis with the f32 matvec,
  reaches Success in both packages, the roots 3.4e-5 apart (rel-inf; held
  to 1e-3).  Run (b), the bf16 basis with the bf16 matvec, ends in
  MaxIters in both at |F|_inf ≈ 31 (port) and 40 (JAX): the bf16 Laplacian
  at α/h² ≈ 9.6e3 stalls it; the two stalled iterates are not compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.ops import krylov as jkry
from nonlinearsolve_tpu.ops import pallas_stencil as jst
from nonlinearsolve_tpu.ops.preconditioners import \
    fft_poisson_preconditioner as jfft
from nonlinearsolve_tpu.solvers.first_order import \
    EisenstatWalkerForcing as JEW
from nonlinearsolve_tpu_torch import _backend, interop
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.ops import krylov as tkry
from nonlinearsolve_tpu_torch.ops import stencil as tst
from nonlinearsolve_tpu_torch.ops.preconditioners import \
    fft_poisson_preconditioner as tfft

torch.set_num_threads(2)


def _k3_inputs(N, seed):
    rng = np.random.default_rng(seed)
    U = rng.random((N, N, 2)).astype(np.float32)
    T = rng.standard_normal((N, N, 2)).astype(np.float32)
    p = np.array([3.4, 1.0, 10.0, 1.0 / (N - 1)], np.float32)
    return U, T, p


def _rel_norm(a, b):
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


@pytest.mark.parametrize("N,seed", [(32, 0), (32, 1), (16, 3)])
def test_k3_matches_jax(N, seed):
    U, T, p = _k3_inputs(N, seed)
    ref32 = np.asarray(jst.brusselator_jvp(jnp.asarray(U), jnp.asarray(T),
                                           jnp.asarray(p)))
    jout = np.asarray(jst.make_brusselator_jvp_bf16(
        jnp.asarray(U), jnp.asarray(p))(jnp.asarray(T)))
    tout = tst.make_brusselator_jvp_bf16(torch.tensor(U),
                                         torch.tensor(p))(torch.tensor(T))
    assert tout.dtype == torch.float32 and tuple(tout.shape) == U.shape
    np.testing.assert_array_equal(tout.numpy(), jout)
    assert _rel_norm(tout.numpy(), ref32) < 2e-2
    assert _rel_norm(jout, ref32) < 2e-2


def test_k3_wrapper_and_factory_on_the_cpu():
    """The raw K3 wrapper on bf16 tensors is the plain version, and the
    factory casts once on the way in and once on the way out; a tangent in
    f64 comes back in f64."""
    U, T, p = (torch.tensor(a) for a in _k3_inputs(24, 5))
    bf = torch.bfloat16
    raw = tst.brusselator_jvp_bf16(U.to(bf), T.to(bf), p)
    assert raw.dtype == bf
    assert torch.equal(raw, tst.brusselator_jvp_bf16_plain(U.to(bf),
                                                           T.to(bf), p))
    mv = tst.make_brusselator_jvp_bf16(U.double(), p.double())
    out = mv(T.double())
    assert out.dtype == torch.float64
    assert torch.equal(out, raw.double())


def test_k3_cpu_path_launches_no_kernel():
    before = dict(_backend.LAUNCHES)
    U, T, p = (torch.tensor(a) for a in _k3_inputs(8, 2))
    tst.make_brusselator_jvp_bf16(U, p)(T)
    assert _backend.LAUNCHES == before


def _sparse_krylov_system():
    """tests/test_sparse_krylov.py:21-44's system."""
    rng = np.random.default_rng(0)
    n = 200
    A = np.diag(np.linspace(1.0, 10.0, n)) + 0.1 * rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    return A, b


def test_gmres_bf16_basis_matches_jax():
    A, b = _sparse_krylov_system()
    jA, tA = jnp.asarray(A), torch.tensor(A)
    jref = jkry.gmres(lambda v: jA @ v, jnp.asarray(b), restart=40,
                      rtol=1e-3, basis_dtype=jnp.bfloat16)
    got = tkry.gmres(lambda v: tA @ v, torch.tensor(b), restart=40,
                     rtol=1e-3, basis_dtype=torch.bfloat16)
    assert got.success and bool(jref.success)
    assert got.iterations <= int(jref.iterations) + 5
    assert got.x.dtype == torch.float64
    direct = np.linalg.solve(A, b)
    rel = np.linalg.norm(got.x.numpy() - direct) / np.linalg.norm(direct)
    assert rel < 2e-2
    # the basis is narrowed: the f64-basis run is not the same run
    f64 = tkry.gmres(lambda v: tA @ v, torch.tensor(b), restart=40,
                     rtol=1e-3)
    assert not torch.equal(f64.x, got.x)


@pytest.mark.parametrize("basis", [torch.bfloat16, torch.float16])
def test_gmres_narrow_basis_on_a_shaped_f32_iterate(basis):
    """A shaped f32 right-hand side: the iterate keeps its shape and dtype,
    and the solve reaches rtol 1e-3."""
    A, b = _sparse_krylov_system()
    tA = torch.tensor(A, dtype=torch.float32)
    res = tkry.gmres(lambda v: (tA @ v.reshape(-1)).reshape(v.shape),
                     torch.tensor(b, dtype=torch.float32).reshape(10, 20),
                     restart=40, rtol=1e-3, basis_dtype=basis)
    assert res.success and tuple(res.x.shape) == (10, 20)
    assert res.x.dtype == torch.float32


def test_gmres_complex_rhs_with_basis_dtype_raises():
    b = torch.ones(8, dtype=torch.complex128)
    with pytest.raises(ValueError, match="REAL basis"):
        tkry.gmres(lambda v: v, b, basis_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="REAL basis"):
        jkry.gmres(lambda v: v, jnp.ones(8, jnp.complex128),
                   basis_dtype=jnp.bfloat16)


@pytest.mark.parametrize("name", ["bf16", "bfloat16", "f16"])
def test_newton_krylov_with_a_narrow_basis_matches_jax(name):
    """tests/test_sparse_krylov.py:46-55: the tanh system, NewtonRaphson
    with Eisenstat–Walker forcing and the narrowed basis, abstol 1e-10."""
    jprob = jnls.NonlinearProblem(lambda u, p: jnp.tanh(u) - 0.25 * u - p,
                                  jnp.zeros((64,)), 0.3)
    jsol = jnls.solve(jprob, jnls.NewtonRaphson(
        linsolve=jnls.LinearSolver(method="gmres", krylov_basis_dtype=name),
        forcing=JEW()), abstol=1e-10)
    tprob = tnls.NonlinearProblem(
        lambda u, p: torch.tanh(u) - 0.25 * u - p,
        torch.zeros(64, dtype=torch.float64), 0.3)
    tsol = tnls.solve(tprob, tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", krylov_basis_dtype=name),
        forcing=tnls.EisenstatWalkerForcing()), abstol=1e-10)
    assert tsol.retcode == tnls.ReturnCode.Success and bool(jsol.success)
    assert float(tsol.resid.abs().max()) < 1e-10
    assert abs(tsol.stats.nsteps - int(jsol.stats.nsteps)) <= 1
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), atol=1e-9)


def _flagship_pair(N, run):
    """bench.py:134-140's algorithm at N (f32) in both packages; run "a" is
    the bf16 basis with the f32 matvec (K1), run "b" the bf16 basis with
    the bf16 matvec (K3) as docs/solvers.md describes the problem."""
    kw = dict(alpha=10.0, h=1.0 / (N - 1), shift=3.0, n_components=2)
    jalg = jnls.NewtonRaphson(
        linsolve=jnls.LinearSolver(method="gmres", restart=8,
                                   krylov_maxiter=100,
                                   precond_fn=jfft((N, N), **kw),
                                   krylov_basis_dtype="bf16"),
        forcing=JEW(eta_0=0.1, eta_max=0.1))
    talg = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=8,
                                   krylov_maxiter=100,
                                   precond_fn=tfft((N, N), **kw),
                                   krylov_basis_dtype="bf16"),
        forcing=tnls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    jprob = jbru.make_problem(N, jnp.float32, pallas_jvp=True)
    tprob = interop.problem_from_numpy(np.asarray(jprob.u0),
                                       np.asarray(jprob.p), kernel_jvp=True,
                                       device="cpu")
    if run == "b":
        jprob = jnls.NonlinearProblem(jnls.NonlinearFunction(
            f=jbru.brusselator_2d,
            jvp=lambda v, U, p: jst.make_brusselator_jvp_bf16(U, p)(v)),
            jprob.u0, jprob.p)
        tprob = tnls.NonlinearProblem(tnls.NonlinearFunction(
            f=tbru.brusselator_2d,
            jvp=lambda v, U, p: tst.make_brusselator_jvp_bf16(U, p)(v)),
            tprob.u0, tprob.p)
    jsol = jnls.solve(jprob, jalg, abstol=5.0, maxiters=30)
    tsol = tnls.solve(tprob, talg, abstol=5.0, maxiters=30)
    return jsol, tsol


@pytest.mark.parametrize("run", ["a", "b"])
def test_flagship_bf16_runs_match_jax(run):
    jsol, tsol = _flagship_pair(32, run)
    assert int(tsol.retcode) == int(jsol.retcode)
    assert abs(tsol.stats.nsteps - int(jsol.stats.nsteps)) <= 1
    t_resid = float(tsol.resid.abs().max())
    j_resid = float(jnp.max(jnp.abs(jsol.resid)))
    assert np.isfinite(t_resid) and np.isfinite(j_resid)
    if run == "a":
        assert tsol.retcode == tnls.ReturnCode.Success
        ref = np.asarray(jsol.u)
        dist = np.abs(tsol.u.numpy() - ref).max() / np.abs(ref).max()
        assert dist < 1e-3
    else:
        assert tsol.retcode == tnls.ReturnCode.MaxIters
        assert t_resid > 5.0 and j_resid > 5.0

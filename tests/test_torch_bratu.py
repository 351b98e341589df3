"""BASELINE config 3 and SNES ex2 on the port's sparse direct route
(nonlinearsolve_tpu_torch/models/bratu.py, snes_ex2.py), against the JAX
package on the same problems: the residuals and the pattern, then
NewtonRaphson with a colored sparse-AD Jacobian on each route the JAX
package takes (the rows of the slice's table at reduced sizes):

- Bratu 24², the default linear solver: block cyclic reduction;
- SNES ex2, n = 128, ``sparse=True``: parallel cyclic reduction;
- Bratu 72² (bandwidth 72 > 64, and RCM finds no band): the AMD host LU;
- Bratu 32² flat, GMRES with ``precond="device_lu"``.

Tolerances: the same retcode and NLStats as the JAX package, roots within
1e-10; the residuals to 1e-12 (f64; XLA may contract a product and a sum
into one rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu.ops.device_lu as jdl
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models import bratu as jbratu
from nonlinearsolve_tpu.models import snes_ex2 as jsnes
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.models import bratu as tbratu
from nonlinearsolve_tpu_torch.models import snes_ex2 as tsnes
from nonlinearsolve_tpu_torch.ops import direct_sparse as tds

torch.set_num_threads(2)

STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def _sparse_nr(mod, **ls):
    return mod.NewtonRaphson(autodiff=mod.JacobianPolicy(mode="sparse"),
                             linsolve=mod.LinearSolver(**ls))


def _check(jsol, tsol, atol=1e-10):
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert {k: int(getattr(tsol.stats, k)) for k in STATS} == \
        {k: int(getattr(jsol.stats, k)) for k in STATS}
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=atol)


def test_residuals_and_pattern_equal_jax():
    rng = np.random.default_rng(0)
    for N in (1, 7, 24):
        u = rng.standard_normal((N, N))
        ref = np.asarray(jbratu.bratu_2d(jnp.asarray(u), 3.5))
        lam = torch.tensor(3.5, dtype=torch.float64)
        got = tbratu.bratu_2d(torch.tensor(u), lam)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())
        jp, tp = jbratu.sparsity_pattern(N), tbratu.sparsity_pattern(N)
        assert np.array_equal(jp.indptr, tp.indptr)
        assert np.array_equal(jp.indices, tp.indices)
    for n in (3, 128):
        x = rng.standard_normal(n)
        ref = np.asarray(jsnes.residual(jnp.asarray(x)))
        got = tsnes.residual(torch.tensor(x)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
    jprob = jsnes.make_problem(16, sparse=True)
    tprob = tsnes.make_problem(16, sparse=True, device="cpu")
    for a, b in zip(jprob.f.sparsity, tprob.f.sparsity):
        assert np.array_equal(a, b)
    assert torch.equal(tprob.u0, torch.full((16,), 0.5, dtype=torch.float64))


def test_make_problem_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (tbratu.make_problem, tsnes.make_problem):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_bratu_config3_block_cyclic_reduction():
    """Row (a) at 24²: bandwidth 24 ≤ 64, so block cyclic reduction every
    step; the root within 1e-10 of the dense NewtonRaphson solve too (as
    tests/test_golden_models.py holds the JAX package)."""
    N = 24
    jsol = jnls.solve(jbratu.make_problem(N), _sparse_nr(jnls),
                      abstol=1e-10)
    _backend.reset_counters()
    tsol = tnls.solve(tbratu.make_problem(N, device="cpu"),
                      _sparse_nr(tnls), abstol=1e-10)
    _check(jsol, tsol)
    assert _backend.ROUTES["bcr"] == tsol.stats.nsolve == 4
    dense = tnls.solve(tbratu.make_problem(N, device="cpu",
                                           with_sparsity=False),
                       tnls.NewtonRaphson(), abstol=1e-10)
    np.testing.assert_allclose(tsol.u.numpy(), dense.u.numpy(), rtol=0,
                               atol=1e-10)


def test_snes_ex2_parallel_cyclic_reduction():
    """Row (b): the tridiagonal Jacobian takes PCR; the dense and sparse
    solves agree to 1e-8 and the boundary values hold to 1e-10 (as
    tests/test_golden_models.py holds the JAX package)."""
    jsol = jnls.solve(jsnes.make_problem(128, sparse=True), _sparse_nr(jnls),
                      abstol=1e-8)
    _backend.reset_counters()
    tsol = tnls.solve(tsnes.make_problem(128, sparse=True, device="cpu"),
                      _sparse_nr(tnls), abstol=1e-8)
    _check(jsol, tsol)
    assert _backend.ROUTES["pcr"] == tsol.stats.nsolve == 3
    dense = tnls.solve(tsnes.make_problem(128, device="cpu"),
                       tnls.NewtonRaphson(), abstol=1e-8)
    np.testing.assert_allclose(dense.u.numpy(), tsol.u.numpy(), atol=1e-8)
    assert abs(float(dense.u[0])) < 1e-10
    assert abs(float(dense.u[-1]) - 1.0) < 1e-10


def test_bratu_host_lu_route():
    """Bratu 72²: bandwidth 72 > 64 and RCM finds no band within 64, so
    the AMD host LU; one factorization, numeric-only refactorizations
    after it."""
    N = 72
    jsol = jnls.solve(jbratu.make_problem(N), _sparse_nr(jnls),
                      abstol=1e-10)
    tds._FACTORS._d.clear()
    _backend.reset_counters()
    tsol = tnls.solve(tbratu.make_problem(N, device="cpu"),
                      _sparse_nr(tnls), abstol=1e-10)
    _check(jsol, tsol)
    assert _backend.ROUTES["host_lu"] == tsol.stats.nsolve == 4
    (fac,) = tds._FACTORS._d.values()
    assert (fac.n_factor, fac.n_refactor) == (1, 3)


def _flat(mod, model, N, device=None):
    """Bratu on the flat state (N·N,): the shape GMRES's sparse route
    needs."""
    def f(u, p):
        return model.bratu_2d(u.reshape(N, N), p).reshape(-1)

    fn = mod.NonlinearFunction(f=f, sparsity=model.sparsity_pattern(N))
    if device is None:
        return mod.NonlinearProblem(fn, jnp.zeros(N * N), jnp.asarray(3.5))
    return mod.NonlinearProblem(fn, torch.zeros(N * N, dtype=torch.float64),
                                torch.tensor(3.5, dtype=torch.float64))


def test_bratu_gmres_with_the_device_lu_preconditioner():
    """Row (e) at 32² flat: GMRES on the CSR Jacobian with the exact device
    LU as its preconditioner — one Krylov iteration a step."""
    N = 32
    ls = dict(method="gmres", precond="device_lu")
    jdl._DEVICE_LU_CACHE.clear()
    jsol = jnls.solve(_flat(jnls, jbratu, N), _sparse_nr(jnls, **ls),
                      abstol=1e-10)
    _backend.reset_counters()
    tsol = tnls.solve(_flat(tnls, tbratu, N, "cpu"), _sparse_nr(tnls, **ls),
                      abstol=1e-10)
    _check(jsol, tsol)
    assert tsol.counters["krylov_iters"] == tsol.stats.nsteps
    # M⁻¹ b and one preconditioned product a step
    assert _backend.ROUTES["device_lu"] == 2 * tsol.stats.nsteps


def test_sparse_lu_device_on_a_dense_jacobian_is_the_dense_lu():
    """``sparse_lu_device`` with a dense Jacobian (Bratu 8² without a
    pattern) takes the dense LU in both packages
    (``nonlinearsolve_tpu/ops/linear_solve.py:130-133``)."""
    ls = dict(method="sparse_lu_device")
    jsol = jnls.solve(jbratu.make_problem(8, with_sparsity=False),
                      jnls.NewtonRaphson(linsolve=jnls.LinearSolver(**ls)),
                      abstol=1e-10)
    _backend.reset_counters()
    tsol = tnls.solve(tbratu.make_problem(8, device="cpu",
                                          with_sparsity=False),
                      tnls.NewtonRaphson(linsolve=tnls.LinearSolver(**ls)),
                      abstol=1e-10)
    _check(jsol, tsol)
    assert not any(_backend.ROUTES.values())

"""Complex states (dense, least squares, Krylov) and normal-form Krylov
least squares against the JAX package, f64 / complex128 on the CPU.

- ``test_complex_eltype`` of ``tests/test_core_solvers.py``: NewtonRaphson,
  Broyden, Klement and the default ladder on u³ − 8 from −0.8 + 1.5i give
  the JAX package's retcode, NLStats and root;
- ``test_complex_nlls``: GaussNewton on the complex fit, the JAX package's
  retcode, NLStats and root;
- holomorphic Jacobians (forward, reverse, finite differences) against
  ``jax.jacfwd`` / ``jax.jacrev(holomorphic=True)``;
- the complex Gauss–Jordan of ``tests/test_sparse_krylov.py:664``, lone and
  batched, against the JAX package's;
- complex Krylov: GMRES and BiCGStab on a seeded nonsymmetric system
  against LU; CG and MINRES on a Hermitian one against the JAX package's
  iterations and solution.  The JAX package's GMRES takes the
  unconjugated inner product on complex states and stalls there, and its
  BiCGStab does not trace (ROADMAP C, caveats): the port conjugates;
- normal-form Krylov least squares (JᵀJ δu = Jᵀfu by vjp∘jvp) on a small
  non-square problem under GaussNewton with each Krylov method: the JAX
  package's retcode, NLStats and root.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.ops import krylov as jkry
from nonlinearsolve_tpu.ops.linear_solve import \
    gauss_jordan_solve as j_gauss_jordan
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.core.autodiff import (JacobianPolicy,
                                                    construct_dense_jacobian_fn)
from nonlinearsolve_tpu_torch.ops import krylov as tkry
from nonlinearsolve_tpu_torch.ops.linear_solve import (gauss_jordan_batched,
                                                       gauss_jordan_solve)

torch.set_num_threads(1)

C128 = torch.complex128
F64 = torch.float64


def _stats(sol):
    s = sol.stats
    return [int(s.nf), int(s.njacs), int(s.nfactors), int(s.nsolve),
            int(s.nsteps)]


@pytest.mark.parametrize("name", ["NewtonRaphson", "Broyden", "Klement",
                                  None])
def test_complex_eltype(name):
    jsol = jnls.solve(jnls.NonlinearProblem(
        lambda u, p: u ** 3 - p, jnp.array([-0.8 + 1.5j], jnp.complex128),
        8.0 + 0j), None if name is None else getattr(jnls, name)())
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: u ** 3 - p, torch.tensor([-0.8 + 1.5j], dtype=C128),
        8.0 + 0j), None if name is None else getattr(tnls, name)())
    assert tsol.u.dtype == C128
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert _stats(tsol) == _stats(jsol)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(complex(tsol.u[0]),
                               2 * np.exp(2j * np.pi / 3), rtol=1e-8)


def test_complex_nlls():
    ts = np.linspace(0.0, 1.0, 8)
    e = np.exp(1j * 2 * np.pi * ts)
    target = (2.0 + 1.0j) * e
    je, te = jnp.asarray(e), torch.tensor(e)
    jsol = jnls.solve(jnls.NonlinearLeastSquaresProblem(
        lambda u, p: u[0] * je - p, jnp.array([0.5 + 0.1j], jnp.complex128),
        jnp.asarray(target)), jnls.GaussNewton())
    tsol = tnls.solve(tnls.NonlinearLeastSquaresProblem(
        lambda u, p: u[0] * te - p, torch.tensor([0.5 + 0.1j], dtype=C128),
        torch.tensor(target)), tnls.GaussNewton())
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert _stats(tsol) == _stats(jsol)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(complex(tsol.u[0]), 2.0 + 1.0j, rtol=1e-8)


def _jholo(u):
    return jnp.stack([u[0] ** 2 * u[1] - 1j, jnp.exp(u[1]) + u[0] * u[2],
                      jnp.sin(u[2]) * u[0]])


def _tholo(u):
    return torch.stack([u[0] ** 2 * u[1] - 1j, torch.exp(u[1]) + u[0] * u[2],
                        torch.sin(u[2]) * u[0]])


@pytest.mark.parametrize("mode", ["forward", "reverse", "finite"])
def test_holomorphic_jacobians(mode):
    u = np.array([0.3 + 0.2j, -0.5 + 1.0j, 1.1 - 0.4j])
    ref = np.asarray(jax.jacfwd(_jholo, holomorphic=True)(jnp.asarray(u)))
    if mode == "reverse":
        np.testing.assert_allclose(np.asarray(jax.jacrev(
            _jholo, holomorphic=True)(jnp.asarray(u))), ref, atol=1e-15)
    J = construct_dense_jacobian_fn(_tholo, JacobianPolicy(mode=mode), 3,
                                    3)(torch.tensor(u))
    assert J.dtype == C128
    np.testing.assert_allclose(J.numpy(), ref, rtol=0,
                               atol=1e-6 if mode == "finite" else 1e-15)


@pytest.mark.parametrize("mode", ["reverse", "finite"])
def test_complex_solve_by_each_jacobian_mode(mode):
    policy = dict(autodiff=JacobianPolicy(mode=mode))
    jsol = jnls.solve(jnls.NonlinearProblem(
        lambda u, p: u ** 3 - p, jnp.array([-0.8 + 1.5j], jnp.complex128),
        8.0 + 0j), jnls.NewtonRaphson(autodiff=jnls.JacobianPolicy(
            mode=mode)))
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: u ** 3 - p, torch.tensor([-0.8 + 1.5j], dtype=C128),
        8.0 + 0j), tnls.NewtonRaphson(**policy))
    assert int(tsol.retcode) == int(jsol.retcode)
    assert _stats(tsol) == _stats(jsol)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               rtol=0, atol=1e-14)


def test_complex_gauss_jordan():
    """tests/test_sparse_krylov.py:664's complex system: the JAX package's
    Gauss–Jordan (modulus pivots); a batch row is its lone solve bit for
    bit."""
    rng = np.random.default_rng(0)
    for n in (1, 2, 4, 7, 17, 32):
        rng.standard_normal((n, n))
        rng.standard_normal(n)
    A = (rng.standard_normal((5, 5)) + 1j * rng.standard_normal((5, 5))
         + 4.0 * np.eye(5))
    b = rng.standard_normal(5) + 1j * rng.standard_normal(5)
    jx = np.asarray(j_gauss_jordan(jnp.asarray(A), jnp.asarray(b)))
    tx = gauss_jordan_solve(torch.tensor(A), torch.tensor(b))
    np.testing.assert_allclose(A @ tx.numpy(), b, atol=1e-10)
    np.testing.assert_allclose(tx.numpy(), jx, rtol=0, atol=1e-14)
    A2 = np.stack([A, A.T + 1j * np.eye(5), A * (0.5 - 0.5j)])
    b2 = np.stack([b, b.conj(), 2 * b])
    bx = gauss_jordan_batched(torch.tensor(A2), torch.tensor(b2))
    for i in range(3):
        assert torch.equal(bx[i], gauss_jordan_solve(torch.tensor(A2[i]),
                                                     torch.tensor(b2[i])))
    # a zero pivot column: non-finite, as the JAX one
    S = A.copy()
    S[:, 2] = 0
    assert not torch.isfinite(gauss_jordan_solve(torch.tensor(S),
                                                 torch.tensor(b))).all()


def _complex_system(n, seed, hermitian=False):
    rng = np.random.default_rng(seed)
    A = (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))) \
        / np.sqrt(n)
    A = A + A.conj().T + 10 * np.eye(n) if hermitian else A + 3 * np.eye(n)
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    return A, b


@pytest.mark.parametrize("method", ["gmres", "bicgstab"])
def test_complex_nonsymmetric_krylov(method):
    A, b = _complex_system(60, 1)
    tA = torch.tensor(A)
    kw = {"restart": 20} if method == "gmres" else {}
    res = tkry.solve_krylov(method, lambda v: tA @ v, torch.tensor(b),
                            rtol=1e-12, maxiter=600, **kw)
    assert res.success and res.x.dtype == C128
    np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b),
                               atol=1e-10)
    assert isinstance(res.residual_norm, np.floating)
    if method == "gmres":
        # the JAX package's GMRES (unconjugated Gram–Schmidt) stalls here
        jres = jkry.gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                          rtol=1e-12, maxiter=600)
        assert not bool(jres.success)
        # restarted with a short basis, and from a nonzero start
        res = tkry.gmres(lambda v: tA @ v, torch.tensor(b), rtol=1e-12,
                         restart=5, maxiter=600,
                         x0=torch.ones(60, dtype=C128))
        assert res.success
        np.testing.assert_allclose(res.x.numpy(), np.linalg.solve(A, b),
                                   atol=1e-10)


@pytest.mark.parametrize("method", ["cg", "minres"])
def test_complex_hermitian_krylov(method):
    A, b = _complex_system(60, 2, hermitian=True)
    jres = getattr(jkry, method)(lambda v: jnp.asarray(A) @ v,
                                 jnp.asarray(b), rtol=1e-12)
    tA = torch.tensor(A)
    tres = getattr(tkry, method)(lambda v: tA @ v, torch.tensor(b),
                                 rtol=1e-12)
    assert tres.success and bool(jres.success)
    assert tres.iterations == int(jres.iterations)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               atol=1e-12)


def test_complex_basis_dtype_refused_and_fetch_keeps_complex():
    with pytest.raises(ValueError, match="REAL basis"):
        tkry.gmres(lambda v: v, torch.ones(4, dtype=C128),
                   basis_dtype=torch.bfloat16)
    z, r, k = _backend.fetch(torch.tensor(1 + 2j, dtype=C128),
                             torch.tensor([0.5], dtype=F64),
                             torch.tensor(3, dtype=torch.int32))
    assert z == 1 + 2j and isinstance(z, np.complex128)
    assert r.dtype == np.float64 and k == 3 and k.dtype == np.int32
    assert _backend.resolve_dtype("complex64") == torch.complex64
    assert _backend.real_np_dtype(C128) is np.float64


def _tanh_problem():
    rng = np.random.default_rng(0)
    m, n = 12, 5
    A, y = rng.standard_normal((m, n)), rng.standard_normal(m)
    jA, jy, tA, ty = jnp.asarray(A), jnp.asarray(y), torch.tensor(A), \
        torch.tensor(y)

    def jf(u, p):
        return jnp.tanh(jA @ u) - 0.5 * jy + 0.1 * u[0] ** 2

    def tf(u, p):
        return torch.tanh(tA @ u) - 0.5 * ty + 0.1 * u[0] ** 2
    return jf, tf, n


@pytest.mark.parametrize("method", ["gmres", "cg", "minres", "bicgstab"])
def test_normal_form_krylov_least_squares(method):
    """A 12 × 5 least-squares problem under GaussNewton with a Krylov
    solver: the normal equations on the matrix-free operator, the JAX
    package's retcode and NLStats, the root within 1e-8 (the Krylov
    solves round otherwise)."""
    jf, tf, n = _tanh_problem()
    jsol = jnls.solve(jnls.NonlinearLeastSquaresProblem(jf, jnp.zeros(n)),
                      jnls.GaussNewton(linsolve=jnls.LinearSolver(
                          method=method)))
    tsol = tnls.solve(tnls.NonlinearLeastSquaresProblem(
        tf, torch.zeros(n, dtype=F64)), tnls.GaussNewton(
            linsolve=tnls.LinearSolver(method=method)))
    assert int(tsol.retcode) == int(jsol.retcode)
    assert _stats(tsol) == _stats(jsol)
    assert tsol.counters["krylov_iters"] > 0
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               atol=1e-8)


def test_normal_form_operator():
    """StatefulJacobianNormalFormOperator is JᵀJ (JᴴJ for a complex
    state) applied without forming J."""
    jf, tf, n = _tanh_problem()
    u = torch.linspace(-0.3, 0.4, n, dtype=F64)
    v = torch.linspace(1.0, 2.0, n, dtype=F64)
    J = torch.func.jacfwd(lambda w: tf(w, None))(u)
    op = tnls.StatefulJacobianNormalFormOperator(
        tnls.JacobianOperator(lambda w: tf(w, None)), u)
    torch.testing.assert_close(op(v), J.T @ (J @ v), rtol=1e-14, atol=0)
    jop = jnls.StatefulJacobianNormalFormOperator(
        jnls.JacobianOperator(lambda w: jf(w, None)), jnp.asarray(u.numpy()))
    np.testing.assert_allclose((op @ v).numpy(),
                               np.asarray(jop @ jnp.asarray(v.numpy())),
                               rtol=1e-14)
    e = torch.tensor(np.exp(1j * np.arange(4.0)))

    def g(w):
        return torch.cat([w * e, w[:2] ** 2])
    w = torch.tensor([0.2 + 0.1j, -0.3j, 1.0, 0.5 - 0.5j], dtype=C128)
    z = torch.tensor([1.0 + 1j, 2.0, -1j, 0.5], dtype=C128)
    Jc = construct_dense_jacobian_fn(g, JacobianPolicy(), 4, 6)(w)
    cop = tnls.StatefulJacobianNormalFormOperator(tnls.JacobianOperator(g),
                                                  w)
    torch.testing.assert_close(cop(z), Jc.mH @ (Jc @ z), rtol=1e-14,
                               atol=1e-15)


@pytest.mark.parametrize("name", ["TrustRegion", "LevenbergMarquardt",
                                  "PseudoTransient", "AndersonAcceleration",
                                  "RobustMultiNewton", "SimpleTrustRegion",
                                  "SimpleDFSane"])
def test_engines_that_order_values_refuse_complex_states(name):
    """The engines that order or compare values run a complex state in
    JAX's lexicographic order (ROADMAP A.33) and give the JAX package's
    retcode, NLStats and root on u³ − 8 from −0.8 + 1.5i (its TrustRegion
    stalls on the unconjugated gradient, its LM succeeds).  They refuse it
    only where the JAX package fails to trace it too: PseudoTransient and
    RobustMultiNewton.  SimpleTrustRegion's JAX run takes the analytic
    Jacobian (the JAX simple tier's jacfwd refuses complex inputs)."""
    jf = jnls.NonlinearFunction(f=lambda u, p: u ** 3 - p,
                                jac=lambda u, p: jnp.diag(3 * u ** 2))
    jprob = jnls.NonlinearProblem(jf, jnp.array([-0.8 + 1.5j],
                                                jnp.complex128), 8.0 + 0j)
    prob = tnls.NonlinearProblem(lambda u, p: u ** 3 - p,
                                 torch.tensor([-0.8 + 1.5j], dtype=C128),
                                 8.0)
    if name in ("PseudoTransient", "RobustMultiNewton"):
        with pytest.raises(TypeError):
            jnls.solve(jprob, getattr(jnls, name)())
        with pytest.raises(NotImplementedError, match="fails to trace"):
            tnls.solve(prob, getattr(tnls, name)())
        return
    jsol = jnls.solve(jprob, getattr(jnls, name)())
    tsol = tnls.solve(prob, getattr(tnls, name)())
    assert int(tsol.retcode) == int(jsol.retcode)
    assert _stats(tsol) == _stats(jsol)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               rtol=0, atol=1e-12)


def test_complex_steepest_descent_follows_the_gradient():
    """SteepestDescent on a complex state steps along −Jᴴ·F, the gradient
    of ½‖F‖² (the JAX package's dense product gives −Jᵀ·F, no descent
    direction on a complex state, and no JAX test reaches it): the first
    five iterates are a plain numpy descent's within 1e-14."""
    rng = np.random.default_rng(3)
    n = 3
    A = 0.6 * np.eye(n) + 0.1 * (rng.standard_normal((n, n))
                                 + 1j * rng.standard_normal((n, n)))
    b = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    tA, tb = torch.tensor(A), torch.tensor(b)
    u0 = np.full(n, 0.1 + 0.2j)
    u = u0.copy()
    for k in range(1, 6):
        J = A + np.diag(0.1 * u)
        u = u - J.conj().T @ (A @ u + 0.05 * u ** 2 - b)
        sol = tnls.solve(tnls.NonlinearProblem(
            lambda w, p: tA @ w + 0.05 * w ** 2 - tb, torch.tensor(u0)),
            tnls.GeneralizedFirstOrderAlgorithm(
                descent=tnls.SteepestDescent()), maxiters=k)
        assert sol.retcode == tnls.ReturnCode.MaxIters
        assert sol.stats.nsteps == k
        np.testing.assert_allclose(sol.u.numpy(), u, rtol=0, atol=1e-14)


@pytest.mark.parametrize("method", ["gmres", "cg", "minres", "bicgstab"])
def test_complex_normal_form_krylov_least_squares(method):
    """A complex 8 × 3 linear fit under GaussNewton with a Krylov solver
    solves JᴴJ δu = Jᴴfu: numpy's least-squares solution within 1e-12, and
    the retcode and NLStats of the dense complex solve (QR with qᴴ, held
    to the JAX package by ``test_complex_nlls``)."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((8, 3)) + 1j * rng.standard_normal((8, 3))
    y = rng.standard_normal(8) + 1j * rng.standard_normal(8)
    tA, ty = torch.tensor(A), torch.tensor(y)
    prob = tnls.NonlinearLeastSquaresProblem(lambda u, p: tA @ u - ty,
                                             torch.zeros(3, dtype=C128))
    tsol = tnls.solve(prob, tnls.GaussNewton(
        linsolve=tnls.LinearSolver(method=method)))
    dsol = tnls.solve(prob, tnls.GaussNewton())
    assert tsol.retcode == dsol.retcode == tnls.ReturnCode.StalledSuccess
    assert _stats(tsol) == _stats(dsol)
    assert tsol.counters["krylov_iters"] > 0
    np.testing.assert_allclose(tsol.u.numpy(),
                               np.linalg.lstsq(A, y, rcond=None)[0],
                               rtol=0, atol=1e-12)

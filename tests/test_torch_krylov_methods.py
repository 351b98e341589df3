"""The port's BiCGStab, CG and MINRES (nonlinearsolve_tpu_torch/ops/
krylov.py) against the JAX package's on the systems of
tests/test_sparse_krylov.py (the tridiagonal n = 50 system, the symmetric
indefinite n = 200 system, the shaped 2D indefinite stencil), with and
without a Jacobi preconditioner, and at a budget that runs out.

Tolerances: x rel-inf 1e-10 (f64; reductions sum in another order; 1e-8
and 1e-6 after the long MINRES runs); iteration counts and the success
flag must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinearsolve_tpu.ops import krylov as jkry
from nonlinearsolve_tpu_torch.ops import krylov as tkry

torch.set_num_threads(2)


def _tridiag(n=50):
    A = (np.diag(4.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1)
         + np.diag(-np.ones(n - 1), -1))
    return A, np.random.default_rng(3).standard_normal(n)


def _indefinite(n=200):
    rng = np.random.default_rng(0)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    eigs = np.concatenate([np.linspace(-5, -0.5, n // 2),
                           np.linspace(0.5, 5, n // 2)])
    A = Q @ np.diag(eigs) @ Q.T
    return A, A @ rng.standard_normal(n)


def _both(method, A, b, precond=False, **kw):
    jA, tA = jnp.asarray(A), torch.tensor(A)
    d = np.abs(np.diag(A)) + 1.0
    jM = (lambda v: v / jnp.asarray(d)) if precond else None
    tM = (lambda v: v / torch.tensor(d)) if precond else None
    ref = jkry.solve_krylov(method, lambda v: jA @ v, jnp.asarray(b),
                            M=jM, **kw)
    got = tkry.solve_krylov(method, lambda v: tA @ v, torch.tensor(b),
                            M=tM, **kw)
    return ref, got


def _assert_same(ref, got, rel=1e-10, res_atol=1e-14):
    assert got.iterations == int(ref.iterations)
    assert got.success == bool(ref.success)
    x_ref = np.asarray(ref.x)
    err = np.abs(got.x.numpy() - x_ref).max() / max(np.abs(x_ref).max(), 1)
    assert err <= rel, err
    np.testing.assert_allclose(got.residual_norm, float(ref.residual_norm),
                               rtol=1e-6, atol=res_atol)


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("method", ["bicgstab", "cg", "minres"])
def test_tridiagonal_matches_jax(method, precond):
    """tests/test_sparse_krylov.py:120-133's system (rtol 1e-10)."""
    A, b = _tridiag()
    ref, got = _both(method, A, b, precond, rtol=1e-10)
    assert got.success
    _assert_same(ref, got)
    np.testing.assert_allclose(got.x.numpy(), np.linalg.solve(A, b),
                               atol=1e-7)


@pytest.mark.parametrize("method", ["bicgstab", "cg", "minres"])
def test_budget_runs_out_as_in_jax(method):
    """maxiter 5 on the tridiagonal system: no success, 5 iterations (the
    restart keyword is dropped for these methods, as in the JAX package).
    (On the indefinite system BiCGStab's third iteration amplifies the
    packages' rounding differences from 1e-13 to 1e-6.)"""
    A, b = _tridiag()
    ref, got = _both(method, A, b, rtol=1e-12, maxiter=5, restart=8)
    assert got.iterations == 5 and not got.success
    _assert_same(ref, got)


def test_minres_symmetric_indefinite_matches_jax():
    """tests/test_sparse_krylov.py:617-646, first half: MINRES on the
    symmetric indefinite n = 200 system (rtol 1e-10, maxiter 600)."""
    A, b = _indefinite()
    ref = jkry.minres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                      rtol=1e-10, maxiter=600)
    tA = torch.tensor(A)
    got = tkry.minres(lambda v: tA @ v, torch.tensor(b), rtol=1e-10,
                      maxiter=600)
    assert got.success
    # after 176 Lanczos steps the true residual (≈ 4e-9, ‖b‖ ≈ 40) is
    # rounding's: it is held to 1e-11·‖b‖
    _assert_same(ref, got, rel=1e-8, res_atol=1e-11 * np.linalg.norm(b))
    rel = np.linalg.norm(A @ got.x.numpy() - b) / np.linalg.norm(b)
    assert rel < 1e-9


def test_minres_shaped_stencil_matches_jax():
    """The second half: MINRES keeps a shaped (32, 32) state on the 2D
    indefinite stencil operator (rtol 1e-8)."""
    rng = np.random.default_rng(0)
    _indefinite()                     # the JAX test's draws come first
    rng.standard_normal((200, 200))
    rng.standard_normal(200)
    N, h = 32, 1.0 / 32
    cfield = 3.0 * rng.random((N, N))
    b2 = rng.standard_normal((N, N))
    jc, tc = jnp.asarray(cfield), torch.tensor(cfield)

    def jop(u):
        lap = (jnp.roll(u, 1, 0) + jnp.roll(u, -1, 0) + jnp.roll(u, 1, 1)
               + jnp.roll(u, -1, 1) - 4 * u)
        return 0.01 * lap / h ** 2 + (1.0 - jc) * u

    def top(u):
        lap = (torch.roll(u, 1, 0) + torch.roll(u, -1, 0)
               + torch.roll(u, 1, 1) + torch.roll(u, -1, 1) - 4 * u)
        return 0.01 * lap / h ** 2 + (1.0 - tc) * u

    ref = jkry.minres(jop, jnp.asarray(b2), rtol=1e-8, maxiter=3000)
    got = tkry.minres(top, torch.tensor(b2), rtol=1e-8, maxiter=3000)
    assert got.success and got.x.shape == (N, N)
    _assert_same(ref, got, rel=1e-6)


def test_zero_rhs_takes_no_iteration():
    A, _ = _tridiag()
    for method in ("bicgstab", "cg", "minres"):
        ref, got = _both(method, A, np.zeros(50), rtol=1e-8)
        assert got.iterations == int(ref.iterations) == 0
        assert got.success == bool(ref.success)

"""Port GMRES (nonlinearsolve_tpu_torch/ops/krylov.py) against the JAX
package's on a fixed nonsymmetric system (n = 200), with and without a
preconditioner, at restart 8 and 30.

Tolerances: x rel-inf 1e-10 (f64; the basis sums are taken in another
order); the iteration counts and the success flag must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinearsolve_tpu.ops import krylov as jkry
from nonlinearsolve_tpu_torch.ops import krylov as tkry

torch.set_num_threads(2)

N = 200


def _system():
    rng = np.random.default_rng(42)
    A = (np.eye(N) * 4.0 + rng.standard_normal((N, N)) / np.sqrt(N)
         + np.diag(np.linspace(0.0, 3.0, N)))
    b = rng.standard_normal(N)
    d = np.diag(A).copy()
    return A, b, d


@pytest.mark.parametrize("precond", [False, True])
@pytest.mark.parametrize("restart", [8, 30])
@pytest.mark.parametrize("rtol", [1e-10, 1e-4])
def test_gmres_matches_jax(restart, precond, rtol):
    A, b, d = _system()
    jA, tA = jnp.asarray(A), torch.tensor(A)
    jM = (lambda v: v / jnp.asarray(d)) if precond else None
    tM = (lambda v: v / torch.tensor(d)) if precond else None
    ref = jkry.gmres(lambda v: jA @ v, jnp.asarray(b), restart=restart,
                     rtol=rtol, M=jM)
    got = tkry.gmres(lambda v: tA @ v, torch.tensor(b), restart=restart,
                     rtol=rtol, M=tM)
    assert got.iterations == int(ref.iterations)
    assert got.success == bool(ref.success)
    x_ref = np.asarray(ref.x)
    assert np.abs(got.x.numpy() - x_ref).max() <= 1e-10 * np.abs(x_ref).max()
    np.testing.assert_allclose(got.residual_norm, float(ref.residual_norm),
                               rtol=1e-6)


def test_gmres_shaped_iterate_and_x0():
    """A shaped (10, 10, 2) right-hand side keeps its shape; a warm start
    goes through the restart residual."""
    A, b, _ = _system()
    jA, tA = jnp.asarray(A), torch.tensor(A)
    x0 = np.random.default_rng(1).standard_normal(N)
    ref = jkry.gmres(lambda v: (jA @ v.reshape(-1)).reshape(v.shape),
                     jnp.asarray(b).reshape(10, 10, 2),
                     jnp.asarray(x0).reshape(10, 10, 2), restart=8,
                     rtol=1e-10)
    got = tkry.gmres(lambda v: (tA @ v.reshape(-1)).reshape(v.shape),
                     torch.tensor(b).reshape(10, 10, 2),
                     torch.tensor(x0).reshape(10, 10, 2), restart=8,
                     rtol=1e-10)
    assert tuple(got.x.shape) == (10, 10, 2)
    assert got.iterations == int(ref.iterations) and got.success
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(ref.x)).max())


def test_gmres_maxiter_and_happy_breakdown():
    A, b, _ = _system()
    tA = torch.tensor(A)
    short = tkry.gmres(lambda v: tA @ v, torch.tensor(b), restart=4,
                       maxiter=8, rtol=1e-14)
    ref = jkry.gmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), restart=4,
                     maxiter=8, rtol=1e-14)
    assert short.iterations == int(ref.iterations) == 8
    assert not short.success and not bool(ref.success)
    # identity operator: exact after one iteration (happy breakdown)
    eye = tkry.gmres(lambda v: v, torch.tensor(b), restart=8, rtol=1e-12)
    assert eye.success and eye.iterations == 1
    np.testing.assert_allclose(eye.x.numpy(), b, rtol=1e-13)


def test_gmres_zero_rhs_and_nonfinite():
    tA = torch.tensor(_system()[0])
    z = tkry.gmres(lambda v: tA @ v, torch.zeros(N), restart=8)
    assert z.success and z.iterations == 0 and not z.x.any()
    bad = tkry.gmres(lambda v: v * float("nan"), torch.ones(N), restart=4,
                     maxiter=8)
    assert not bad.success


def test_solve_krylov_routes():
    tA = torch.tensor(_system()[0])
    b = torch.ones(N, dtype=torch.float64)
    assert tkry.solve_krylov("gmres", lambda v: tA @ v, b, rtol=1e-8).success
    # the short-recurrence methods run since ROADMAP A.33: BiCGStab solves
    # this nonsymmetric A; CG and MINRES (symmetric methods) spend their
    # budget on it
    assert tkry.solve_krylov("bicgstab", lambda v: tA @ v, b,
                             rtol=1e-8).success
    for method in ("cg", "minres"):
        res = tkry.solve_krylov(method, lambda v: tA @ v, b, rtol=1e-8,
                                maxiter=20)
        assert res.iterations == 20 and not res.success
    with pytest.raises(ValueError):
        tkry.solve_krylov("nope", lambda v: tA @ v, b)

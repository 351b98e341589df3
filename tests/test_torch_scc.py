"""``SCCNonlinearProblem`` against the JAX package: the SCC cases of
``tests/test_homotopy_scc.py`` and ``tests/test_interfaces.py``
(``test_scc_alg_constructor``, ``test_scc_and_ensemble_maxtime_paths``),
f64 on the CPU.

Each SCC solve is held to the JAX package's retcode and summed ``NLStats``
and to its concatenated u within 1e-10.  The homotopy block takes the
SCC's nonlinear algorithm as its inner corrector: both packages run it
with ``SCCAlg(nlalg=NewtonRaphson())``, and the port alone with the JAX
test's default (the FastShortcut polyalgorithm; see
``test_torch_homotopy_default.py`` on its JAX plans).  Derivatives
through SCC chains: ``test_torch_homotopy_sensitivity.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls

torch.set_num_threads(1)

STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def t64(x):
    return torch.tensor(x, dtype=torch.float64)


def assert_same(jsol, tsol, atol=1e-10):
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tuple(getattr(tsol.stats, k) for k in STATS) == tuple(
        int(getattr(jsol.stats, k)) for k in STATS)
    np.testing.assert_allclose(tsol.u.detach().numpy(), np.asarray(jsol.u),
                               rtol=0, atol=atol)


def square(u, p):
    return u * u - p


def cube(u, p):
    return u ** 3 - p


def shifted(u, p):
    return u - p


def test_scc_sequential_blocks():
    """Two nonlinear blocks and a linear one, later blocks taking earlier
    solutions through ``explicitfuns``."""
    def ef2(p, sols):
        return sols[0].u[0]

    def ef3(p, sols):
        return sols[0].u[0] + sols[1].u[0]

    jprob = jnls.SCCNonlinearProblem(
        [jnls.NonlinearProblem(square, jnp.array([1.0]), 4.0),
         jnls.NonlinearProblem(cube, jnp.array([1.0])),
         jnls.LinearSCCBlock(A=lambda p: jnp.array([[2.0]]),
                             b=lambda p: jnp.array([p]))],
        explicitfuns=[None, ef2, ef3])
    tprob = tnls.SCCNonlinearProblem(
        [tnls.NonlinearProblem(square, t64([1.0]), 4.0),
         tnls.NonlinearProblem(cube, t64([1.0])),
         tnls.LinearSCCBlock(A=lambda p: t64([[2.0]]),
                             b=lambda p: p.reshape(1))],
        explicitfuns=[None, ef2, ef3])
    jsol, tsol = jnls.solve(jprob), tnls.solve(tprob)
    assert_same(jsol, tsol)
    assert tsol.success
    np.testing.assert_allclose(tsol.u.numpy(),
                               [2.0, 2.0 ** (1 / 3),
                                (2.0 + 2.0 ** (1 / 3)) / 2.0], rtol=1e-8)
    assert [type(s).__name__ for s in tsol.original] == [
        "NonlinearSolution"] * 3


def H_block(u, q, lam):
    return lam * (u ** 3 + 2.0 * u - q) + (1 - lam) * (u - 0.5)


def test_scc_homotopy_block():
    """A HomotopyProblem block is swept by continuation with the SCC's
    algorithm as its inner corrector."""
    def p_of(p, sols):
        return float(sols[0].u[0])

    def make(m, u0):
        return m.SCCNonlinearProblem(
            [m.NonlinearProblem(lambda u, p: u ** 2 - 4.0, u0([1.0])),
             m.HomotopyProblem(H_block, u0([0.0]), None)],
            explicitfuns=[None, p_of])

    jsol = jnls.solve(make(jnls, jnp.array),
                      jnls.SCCAlg(nlalg=jnls.NewtonRaphson()))
    tsol = tnls.solve(make(tnls, t64),
                      tnls.SCCAlg(nlalg=tnls.NewtonRaphson()))
    assert_same(jsol, tsol)
    for sol in (tsol, tnls.solve(make(tnls, t64))):
        assert sol.success
        x, y = float(sol.u[0]), float(sol.u[1])
        assert abs(x - 2.0) <= 2e-10
        assert abs(y ** 3 + 2.0 * y - x) <= 1e-8 * x


def plus_one(u, p):
    return u * u + 1.0


def test_scc_failure_propagates():
    """The first failing block's code is the SCC's."""
    def make(m, u1, u2):
        return m.SCCNonlinearProblem([m.NonlinearProblem(plus_one, u1),
                                      m.NonlinearProblem(shifted, u2, 1.0)])
    jsol = jnls.solve(make(jnls, jnp.array([1.0]), jnp.array([0.0])),
                      jnls.NewtonRaphson(), maxiters=50)
    tsol = tnls.solve(make(tnls, t64([1.0]), t64([0.0])),
                      tnls.NewtonRaphson(), maxiters=50)
    assert int(tsol.retcode) == int(jsol.retcode)
    assert not tsol.success
    assert tsol.retcode == tsol.original[0].retcode
    assert tsol.original[1].success


def two_blocks(m, u0):
    return m.SCCNonlinearProblem(probs=(
        m.NonlinearProblem(square, u0([1.0]), 4.0),
        m.NonlinearProblem(shifted, u0([0.0]), 3.0)))


def test_scc_alg_constructor():
    """``SCCAlg``: ``nlalg`` for the nonlinear blocks, ``linalg`` for the
    linear ones, ``store_original`` for ``sol.original``."""
    jsol = jnls.solve(two_blocks(jnls, jnp.array), jnls.SCCAlg(
        nlalg=jnls.NewtonRaphson(), linalg=jnls.LinearSolver(method="lu")),
        abstol=1e-10)
    tsol = tnls.solve(two_blocks(tnls, t64), tnls.SCCAlg(
        nlalg=tnls.NewtonRaphson(), linalg=tnls.LinearSolver(method="lu")),
        abstol=1e-10)
    assert_same(jsol, tsol)
    np.testing.assert_allclose(tsol.u.numpy(), [2.0, 3.0], atol=1e-8)
    assert tsol.original is not None and len(tsol.original) == 2
    sol2 = tnls.solve(two_blocks(tnls, t64),
                      tnls.SCCAlg(store_original=False), abstol=1e-10)
    assert sol2.original is None and sol2.success
    assert tnls.SCCAlg() == tnls.SCCAlg(nlalg=None, linalg=None,
                                        store_original=True)


def test_scc_linear_block_solver():
    """A linear block goes through the SCCAlg's ``linalg`` (QR and LU on a
    3×3 system) and its fallback: a singular block takes the ridge retry,
    with the JAX package's retcode and solution."""
    A = np.array([[4.0, 1.0, 0.0], [1.0, 3.0, 1.0], [0.0, 1.0, 2.0]])
    b = np.array([1.0, 2.0, 3.0])

    def make(m, A_, b_):
        return m.SCCNonlinearProblem([m.LinearSCCBlock(A=lambda p: A_,
                                                       b=lambda p: b_)])
    for method in ("lu", "qr"):
        jsol = jnls.solve(make(jnls, jnp.asarray(A), jnp.asarray(b)),
                          jnls.SCCAlg(linalg=jnls.LinearSolver(method=method)))
        tsol = tnls.solve(make(tnls, torch.as_tensor(A), torch.as_tensor(b)),
                          tnls.SCCAlg(linalg=tnls.LinearSolver(method=method)))
        assert_same(jsol, tsol, atol=1e-14)
    S = np.array([[1.0, 2.0], [2.0, 4.0]])
    jsol = jnls.solve(make(jnls, jnp.asarray(S), jnp.array([1.0, 2.0])))
    tsol = tnls.solve(make(tnls, torch.as_tensor(S), t64([1.0, 2.0])))
    assert_same(jsol, tsol, atol=1e-12)


def test_scc_and_ensemble_maxtime_paths():
    """``maxtime`` applies to each block through the front door (the
    iterator); an ensemble with ``maxtime`` raises a clear
    NotImplementedError.  The JAX package's iterator leaves the residual
    at its safe-best iterate out of nf, where its plain solve counts it;
    the port counts it on both paths, so nf is one above a block
    (ROADMAP C), the other counts equal."""
    jsol = jnls.solve(two_blocks(jnls, jnp.array), jnls.NewtonRaphson(),
                      maxtime=30.0, abstol=1e-10)
    tsol = tnls.solve(two_blocks(tnls, t64), tnls.NewtonRaphson(),
                      maxtime=30.0, abstol=1e-10)
    plain = jnls.solve(two_blocks(jnls, jnp.array), jnls.NewtonRaphson(),
                       abstol=1e-10)
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tsol.stats.nf == int(jsol.stats.nf) + 2 == int(plain.stats.nf)
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    assert tsol.stats.njacs == int(jsol.stats.njacs)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-10)
    assert tsol.success
    np.testing.assert_allclose(tsol.u.numpy(), [2.0, 3.0], atol=1e-8)
    with pytest.raises(NotImplementedError, match="ensemble"):
        tnls.solve_ensemble(tnls.NonlinearProblem(square, t64([1.0]), 2.0),
                            tnls.NewtonRaphson(),
                            u0s=torch.ones((3, 1), dtype=torch.float64),
                            maxtime=1.0)


def test_scc_solve_up():
    """``scc_solve_up``: a new ``p`` replaces ``prob.p``, which reaches a
    block through its explicit function; ``sensealg`` and ``u0`` are
    accepted and ignored."""
    def make(m, u0, p):
        return m.SCCNonlinearProblem(
            (m.NonlinearProblem(square, u0([1.0])),),
            explicitfuns=(lambda q, sols: q,), p=p)
    jsol = jnls.scc_solve_up(make(jnls, jnp.array, 4.0), sensealg=None,
                             u0=None, p=9.0, alg=jnls.NewtonRaphson())
    tsol = tnls.scc_solve_up(make(tnls, t64, 4.0), sensealg=None, u0=None,
                             p=9.0, alg=tnls.NewtonRaphson())
    assert_same(jsol, tsol)
    assert abs(float(tsol.u[0]) - 3.0) <= 1e-10

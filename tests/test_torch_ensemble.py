"""Ensembles against the JAX package: the tests of
``tests/test_ensemble_checkpoint.py`` (its lines 16-38 and 67-112; the
checkpoint test is in ``test_torch_interfaces.py`` and the mesh test is
ROADMAP A.29) in both packages
on the same inputs, f64 on the CPU.

Each trajectory must give the JAX package's vmapped result: the same
retcode and ``NLStats`` and a root within rel 1e-12 (``ROOT_RTOL``); the
JAX tests' own bounds hold too (rel 1e-10, and 1e-6 at scale).  A batch on
the simple tier must equal its lone solves bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls

torch.set_num_threads(1)

F64 = torch.float64
ROOT_RTOL = 1e-12
STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def quadratic(u, p):
    return u * u - p


def _t(x):
    return torch.tensor(x, dtype=F64)


def _same_as_jax(jsols, tsol):
    """Per trajectory: the JAX package's retcode and NLStats, roots within
    ROOT_RTOL."""
    np.testing.assert_array_equal(tsol.retcode.numpy(),
                                  np.asarray(jsols.retcode))
    for k in STATS:
        np.testing.assert_array_equal(getattr(tsol.stats, k).numpy(),
                                      np.asarray(getattr(jsols.stats, k)),
                                      err_msg=k)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsols.u),
                               rtol=ROOT_RTOL, atol=0)


def test_solve_ensemble_over_ps():
    ps = np.array([1.0, 2.0, 3.0, 4.0])
    jsols = jnls.solve_ensemble(
        jnls.NonlinearProblem(quadratic, jnp.array([1.0]), 2.0),
        jnls.NewtonRaphson(), ps=jnp.asarray(ps))
    tsols = tnls.solve_ensemble(
        tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0),
        tnls.NewtonRaphson(), ps=_t(ps))
    _same_as_jax(jsols, tsols)
    np.testing.assert_allclose(tsols.u.numpy().ravel(), np.sqrt(ps),
                               rtol=1e-10)
    assert tsols.retcode.dtype == torch.int32
    assert bool(tsols.success.all())


def test_solve_ensemble_over_u0s_and_ps():
    u0s, ps = np.array([[0.5], [1.0], [2.0]]), np.array([4.0, 9.0, 16.0])
    jsols = jnls.solve_ensemble(
        jnls.NonlinearProblem(quadratic, jnp.array([1.0]), 2.0),
        jnls.NewtonRaphson(), u0s=jnp.asarray(u0s), ps=jnp.asarray(ps))
    tsols = tnls.solve_ensemble(
        tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0),
        tnls.NewtonRaphson(), u0s=_t(u0s), ps=_t(ps))
    _same_as_jax(jsols, tsols)
    np.testing.assert_allclose(tsols.u.numpy().ravel(), [2.0, 3.0, 4.0],
                               rtol=1e-10)


def test_ensemble_with_polyalg():
    ps = np.array([2.0, 5.0])
    jsols = jnls.solve_ensemble(
        jnls.NonlinearProblem(quadratic, jnp.array([1.0]), 2.0),
        ps=jnp.asarray(ps))
    tsols = tnls.solve_ensemble(
        tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0), ps=_t(ps))
    _same_as_jax(jsols, tsols)
    assert (tsols.retcode.numpy() == 1).all()


def test_ensemble_problem_vmapped():
    """EnsembleProblem(prob, prob_func) + solve(trajectories=N): one batch
    when the trajectories share the base structure."""
    jbase = jnls.NonlinearProblem(lambda u, p: u ** 2 - p, jnp.array([1.0]),
                                  2.0)
    jsol = jnls.solve(jnls.EnsembleProblem(
        jbase, prob_func=lambda prob, i: prob.remake(p=jnp.asarray(i + 1.0))),
        jnls.NewtonRaphson(), trajectories=5)
    tbase = tnls.NonlinearProblem(lambda u, p: u ** 2 - p, _t([1.0]), 2.0)
    tsol = tnls.solve(tnls.EnsembleProblem(
        tbase, prob_func=lambda prob, i: prob.remake(p=_t(i + 1.0))),
        tnls.NewtonRaphson(), trajectories=5)
    assert tsol.u.shape == (5, 1)
    _same_as_jax(jsol, tsol)
    np.testing.assert_allclose(tsol.u.numpy()[:, 0],
                               np.sqrt(np.arange(1.0, 6.0)), rtol=1e-10)


@pytest.mark.parametrize("alg", ["SimpleNewtonRaphson", "SimpleBroyden"])
def test_ensemble_problem_on_the_simple_tier(alg):
    """The same ensemble on the simple tier runs as one lockstep batch;
    trajectories given as Python floats stack in f64."""
    jbase = jnls.NonlinearProblem(quadratic, jnp.array([1.0, 0.5]), 2.0)
    jsol = jnls.solve(jnls.EnsembleProblem(
        jbase, prob_func=lambda prob, i: prob.remake(p=i + 1.0)),
        getattr(jnls, alg)(), trajectories=6)
    tbase = tnls.NonlinearProblem(quadratic, _t([1.0, 0.5]), 2.0)
    tsol = tnls.solve(tnls.EnsembleProblem(
        tbase, prob_func=lambda prob, i: prob.remake(p=i + 1.0)),
        getattr(tnls, alg)(), trajectories=6)
    assert tsol.u.shape == (6, 2) and tsol.resid.shape == (6, 2)
    _same_as_jax(jsol, tsol)


def test_ensemble_problem_heterogeneous_falls_back():
    """Trajectories of different sizes solve one by one: a list."""
    base = tnls.NonlinearProblem(lambda u, p: u ** 2 - p, _t([1.0]), 4.0)
    jbase = jnls.NonlinearProblem(lambda u, p: u ** 2 - p, jnp.array([1.0]),
                                  4.0)
    sols = tnls.solve(tnls.EnsembleProblem(
        base, prob_func=lambda prob, i: prob.remake(
            u0=torch.ones(i + 1, dtype=F64))), tnls.NewtonRaphson(),
        trajectories=3)
    jsols = jnls.solve(jnls.EnsembleProblem(
        jbase, prob_func=lambda prob, i: prob.remake(u0=jnp.ones(i + 1))),
        jnls.NewtonRaphson(), trajectories=3)
    assert isinstance(sols, list) and len(sols) == 3
    for i, (s, j) in enumerate(zip(sols, jsols)):
        assert s.u.shape == (i + 1,)
        np.testing.assert_allclose(s.u.numpy(), 2.0, rtol=1e-10)
        assert (int(s.retcode), s.stats.nsteps, s.stats.nf) == (
            int(j.retcode), int(j.stats.nsteps), int(j.stats.nf))


def test_ensemble_at_scale():
    """Kernels in kernels: 4096 SimpleNewtonRaphson solves as one lockstep
    batch, each trajectory the JAX package's vmapped one."""
    n_batch = 4096
    ps = np.linspace(0.5, 10.0, n_batch)

    def jone(p):
        s = jnls.solve(jnls.NonlinearProblem(lambda u, q: u * u - q,
                                             jnp.array([1.0]), p),
                       jnls.SimpleNewtonRaphson())
        return s.u[0], s.retcode, s.stats.nsteps, s.stats.nf

    ju, jcode, jsteps, jnf = jax.jit(jax.vmap(jone))(jnp.asarray(ps))
    tsol = tnls.solve_ensemble(
        tnls.NonlinearProblem(lambda u, q: u * u - q, _t([1.0])),
        tnls.SimpleNewtonRaphson(), ps=_t(ps))
    np.testing.assert_allclose(tsol.u.numpy()[:, 0], np.sqrt(ps), rtol=1e-6)
    np.testing.assert_allclose(tsol.u.numpy()[:, 0], np.asarray(ju),
                               rtol=ROOT_RTOL, atol=0)
    np.testing.assert_array_equal(tsol.retcode.numpy(), np.asarray(jcode))
    np.testing.assert_array_equal(tsol.stats.nsteps.numpy(),
                                  np.asarray(jsteps))
    np.testing.assert_array_equal(tsol.stats.nf.numpy(), np.asarray(jnf))
    # one flag read a step: the slowest row's steps, one more to see that
    # every row has stopped
    assert tsol.counters["host_syncs"] == int(tsol.stats.nsteps.max()) + 1


def test_bracketing_ensemble():
    """An EnsembleProblem of interval problems runs as one bracketing
    batch; the endpoints may vary by trajectory."""
    base = tnls.IntervalNonlinearProblem(lambda u, p: u * u - p,
                                         (_t(0.1), _t(5.0)), _t(2.0))
    sol = tnls.solve(tnls.EnsembleProblem(
        base, prob_func=lambda prob, i: prob.remake(
            tspan=(_t(0.1), _t(5.0 + i)), p=_t(i + 1.0))), tnls.ITP(),
        trajectories=4)
    assert sol.u.shape == sol.retcode.shape == (4,)
    np.testing.assert_allclose(sol.u.numpy(), np.sqrt(np.arange(1.0, 5.0)),
                               atol=1e-8)
    for i in range(4):
        lone = tnls.solve(tnls.IntervalNonlinearProblem(
            lambda u, p: u * u - p, (_t(0.1), _t(5.0 + i)), _t(i + 1.0)),
            tnls.ITP())
        assert float(lone.u) == float(sol.u[i])
        assert lone.stats.nf == int(sol.stats.nf[i])


def test_ensemble_options_refused():
    prob = tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0)
    with pytest.raises(NotImplementedError, match="maxtime"):
        tnls.solve_ensemble(prob, tnls.NewtonRaphson(), ps=_t([1.0, 2.0]),
                            maxtime=1.0)
    # mesh= (ROADMAP A.29) runs: on a one-rank gloo mesh the
    # rows are the unsharded ensemble's, as DTensors
    import torch.distributed as dist

    from nonlinearsolve_tpu_torch.parallel import create_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        sharded = tnls.solve_ensemble(
            prob, tnls.NewtonRaphson(), ps=_t([1.0, 2.0]),
            mesh=create_mesh(axis_names=("batch",)))
        plain = tnls.solve_ensemble(prob, tnls.NewtonRaphson(),
                                    ps=_t([1.0, 2.0]))
        assert torch.equal(sharded.u.full_tensor(), plain.u)
        assert torch.equal(sharded.retcode.full_tensor(), plain.retcode)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="u0s and/or ps"):
        tnls.solve_ensemble(prob, tnls.NewtonRaphson())
    with pytest.raises(TypeError, match="ensemble"):
        tnls.solve(prob, tnls.NewtonRaphson(), trajectories=2)
    with pytest.raises(TypeError, match="abstoll"):
        tnls.solve(tnls.EnsembleProblem(prob), tnls.NewtonRaphson(),
                   trajectories=2, abstoll=1.0)

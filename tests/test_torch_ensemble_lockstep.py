"""Lockstep first-order engines and ladders for ensembles
(``solvers/first_order_lockstep.py``, ROADMAP A.29) on the CPU in f64.

Every row of a lockstep batch must equal its lone ``solve`` bit for bit
(``u``, ``resid``, ``retcode`` and every NLStats field) under
NewtonRaphson (LU and QR, with and without BackTracking), TrustRegion
(simple and Fan), LevenbergMarquardt (with and without the geodesic
step), Broyden (good and bad), Klement and the ladders of them (the
default one among them), from seeded starts on three of the JAX
package's test problems: ``u² − p`` over ``ps``
(``tests/test_ensemble_checkpoint.py``), the 23-problem #9 and Wood (#4),
and the 4×4 dense Brusselator over A.  The batch reads the host the same
number of times at 2B rows as at B.  The lone solves are held against the
JAX package elsewhere; here the batch is also held against the JAX
package's ``solve_ensemble`` on its own tests' problems (roots within
1e-10, NLStats equal to the JAX package's lone solves; on ``u² − p``
LevenbergMarquardt's are held through the residual rounded as XLA's
fused multiply-add, ROADMAP C.7).  Every option the
batch does not take keeps the trajectory-by-trajectory route, and
``sol.counters["ensemble_route"]`` says which ran.

A residual with a matrix product inside (the 23-problem #23,
Chandrasekhar's ``kernel @ x``) rounds otherwise under ``torch.func.vmap``
on the CPU (a batched product), so its rows part from its lone solves in
the last bits (ROADMAP C, caveats); the problems here have none.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models.problems23 import PROBLEMS_23 as JP23
from nonlinearsolve_tpu_torch.core.lockstep import pow_as_host
from nonlinearsolve_tpu_torch.models import brusselator
from nonlinearsolve_tpu_torch.models.problems23 import PROBLEMS_23 as TP23

torch.set_num_threads(1)

F64 = torch.float64
STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def quadratic(u, p):
    return u * u - p


def _t(x):
    return torch.tensor(x, dtype=F64)


ENGINES = {
    "newton": lambda: tnls.NewtonRaphson(),
    "newton_qr": lambda: tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="qr")),
    "newton_backtracking": lambda: tnls.NewtonRaphson(
        linesearch=tnls.BackTracking()),
    "trust_region": lambda: tnls.TrustRegion(),
    "trust_region_fan": lambda: tnls.TrustRegion(radius_update_scheme="fan"),
    "levenberg_marquardt": lambda: tnls.LevenbergMarquardt(),
    "levenberg_marquardt_plain": lambda: tnls.LevenbergMarquardt(
        disable_geodesic=True),
    "broyden": lambda: tnls.Broyden(),
    "broyden_bad": lambda: tnls.Broyden(update_rule="bad_broyden"),
    "klement": lambda: tnls.Klement(),
    "default_ladder": lambda: tnls.FastShortcutNonlinearPolyalg(),
    "ladder_short": lambda: tnls.FastShortcutNonlinearPolyalg(u0_len=10),
    "ladder_jacobian": lambda: tnls.FastShortcutNonlinearPolyalg(
        must_use_jacobian=True),
}


def _quadratic_case():
    rng = np.random.default_rng(3)
    prob = tnls.NonlinearProblem(quadratic, _t([1.0]), _t(2.0))
    return prob, None, _t(rng.uniform(0.1, 5.0, 6)), {}


def _p23_case(index, rows, scale, seed):
    tp = TP23[index - 1]
    rng = np.random.default_rng(seed)
    start = tp.start[None, :]
    u0s = start + scale * rng.standard_normal((rows, start.size)) * (
        1.0 + np.abs(start))
    return (tnls.NonlinearProblem(tp.f, _t(tp.start)), _t(u0s), None,
            {"maxiters": 40})


def _brusselator_case():
    prob = brusselator.make_problem(4, device="cpu")
    ps = prob.p[None, :].repeat(2, 1)
    ps[:, 0] = _t([2.9, 3.9])
    return prob, None, ps, {}


CASES = {
    "quadratic": _quadratic_case,
    "p23_9": lambda: _p23_case(9, 6, 2.0, 0),
    "p23_4_wood": lambda: _p23_case(4, 3, 1.0, 1),
    "brusselator_4x4": _brusselator_case,
}


def _assert_rows_are_lone_solves(prob, alg, u0s, ps, kw, sol):
    B = (u0s if u0s is not None else ps).shape[0]
    for i in range(B):
        lone = tnls.solve(prob.remake(u0=prob.u0 if u0s is None else u0s[i],
                                      p=prob.p if ps is None else ps[i]),
                          alg, **kw)
        assert torch.equal(sol.u[i], lone.u), i
        assert torch.equal(sol.resid[i], lone.resid), i
        assert int(sol.retcode[i]) == int(lone.retcode), i
        for k in STATS:
            assert int(getattr(sol.stats, k)[i]) == int(getattr(lone.stats,
                                                                k)), (i, k)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("engine", list(ENGINES))
def test_lockstep_rows_equal_lone_solves(engine, case):
    prob, u0s, ps, kw = CASES[case]()
    alg = ENGINES[engine]()
    sol = tnls.solve_ensemble(prob, alg, u0s=u0s, ps=ps, **kw)
    assert sol.counters["ensemble_route"] == "lockstep"
    _assert_rows_are_lone_solves(prob, alg, u0s, ps, kw, sol)


@pytest.mark.parametrize("exponent", [0.99, 1.5])
def test_pow_as_host_rounds_as_the_c_library(exponent):
    """``pow_as_host`` equals numpy's scalar power (the C library's
    ``pow``, which the lone engines' host scalars take) bit for bit on
    1000 seeded values, where torch's vectorized power parts on some;
    the Fan scheme's radius and LM's uphill test take it."""
    x = _t(np.random.default_rng(7).uniform(1e-3, 10.0, 1000))
    want = [float(np.float64(v) ** np.float64(exponent))
            for v in x.tolist()]
    assert pow_as_host(x, exponent).tolist() == want


@pytest.mark.parametrize("engine", list(ENGINES))
def test_host_reads_do_not_grow_with_the_batch(engine):
    """The same rows twice over: the same rows out, the same reads."""
    prob, u0s, ps, kw = _p23_case(9, 4, 2.0, 2)
    alg = ENGINES[engine]()
    one = tnls.solve_ensemble(prob, alg, u0s=u0s, **kw)
    two = tnls.solve_ensemble(prob, alg, u0s=torch.cat([u0s, u0s]), **kw)
    assert two.counters["host_syncs"] == one.counters["host_syncs"]
    assert torch.equal(two.u, torch.cat([one.u, one.u]))
    assert torch.equal(two.retcode, torch.cat([one.retcode, one.retcode]))


# the JAX package's solve_ensemble on its tests' problems
# (tests/test_ensemble_checkpoint.py:16-37 and :67-80)

JAX_ENGINES = {
    "newton": lambda m: m.NewtonRaphson(),
    "newton_backtracking": lambda m: m.NewtonRaphson(
        linesearch=m.BackTracking()),
    "trust_region": lambda m: m.TrustRegion(),
    "trust_region_fan": lambda m: m.TrustRegion(radius_update_scheme="fan"),
    "levenberg_marquardt": lambda m: m.LevenbergMarquardt(),
    "ladder_short": lambda m: m.FastShortcutNonlinearPolyalg(u0_len=1),
}


def _fma_quadratic(u, p):
    """``u · u − p`` rounded once, as XLA's CPU compiler contracts the JAX
    package's ``u * u - p`` into one fused multiply-add."""
    ps = torch.as_tensor(p, dtype=u.dtype).expand(u.shape).reshape(-1)
    return torch.tensor([float(Fraction(x) * Fraction(x) - Fraction(q))
                         for x, q in zip(u.reshape(-1).tolist(),
                                         ps.tolist())],
                        dtype=u.dtype).reshape(u.shape)


def _same_stats_as_jax(engine, tsol, stats, quadratic_rows=None):
    """The JAX package's lone NLStats.  On ``u² − p`` XLA contracts the
    residual into a fused multiply-add, and LevenbergMarquardt's geodesic
    accept test 2‖a‖ ≤ α‖v‖ meets exact ties there (p = 4u0²) that the
    last bit of f(u + h·v) decides (ROADMAP C.7,
    ``tools/lm_geodesic_tie_trace.py``).  So on the quadratic
    (``quadratic_rows``: each row's (u0, p)) LM's counts are held to the
    port's lone solves of the residual rounded as that contraction; its
    batch rows equal the port's lone solves of ``u * u - p``
    (``test_lockstep_rows_equal_lone_solves``)."""
    if engine == "levenberg_marquardt" and quadratic_rows is not None:
        fn = tnls.NonlinearFunction(
            _fma_quadratic, jac=lambda u, p: torch.diag(2.0 * u))
        rows = [tnls.solve(tnls.NonlinearProblem(fn, _t([u0]), p),
                           tnls.LevenbergMarquardt())
                for u0, p in quadratic_rows]
        for k in STATS:
            assert [int(getattr(r.stats, k)) for r in rows] == stats[k], k
        return
    for k in STATS:
        assert getattr(tsol.stats, k).tolist() == stats[k], k


def _stats_of_jax_lone(jprob_of, jalg, n):
    rows = [jnls.solve(jprob_of(i), jalg) for i in range(n)]
    return {k: [int(getattr(r.stats, k)) for r in rows] for k in STATS}, \
        [int(r.retcode) for r in rows]


@pytest.mark.parametrize("engine", list(JAX_ENGINES))
def test_over_ps_matches_jax(engine):
    ps = np.array([1.0, 2.0, 3.0, 4.0])
    jalg, talg = JAX_ENGINES[engine](jnls), JAX_ENGINES[engine](tnls)
    jprob = jnls.NonlinearProblem(quadratic, jnp.array([1.0]), 2.0)
    jsols = jnls.solve_ensemble(jprob, jalg, ps=jnp.asarray(ps))
    tsol = tnls.solve_ensemble(
        tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0), talg, ps=_t(ps))
    assert tsol.counters["ensemble_route"] == "lockstep"
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsols.u),
                               rtol=1e-10, atol=0)
    np.testing.assert_allclose(tsol.u.numpy().ravel(), np.sqrt(ps),
                               rtol=1e-10)
    stats, codes = _stats_of_jax_lone(
        lambda i: jprob.remake(p=jnp.asarray(ps[i])), jalg, len(ps))
    assert tsol.retcode.tolist() == codes
    _same_stats_as_jax(engine, tsol, stats, [(1.0, p) for p in ps])


@pytest.mark.parametrize("engine", ["newton", "trust_region",
                                    "levenberg_marquardt"])
def test_over_u0s_and_ps_matches_jax(engine):
    u0s = np.array([[0.5], [1.0], [2.0]])
    ps = np.array([4.0, 9.0, 16.0])
    jalg, talg = JAX_ENGINES[engine](jnls), JAX_ENGINES[engine](tnls)
    jprob = jnls.NonlinearProblem(quadratic, jnp.array([1.0]), 2.0)
    jsols = jnls.solve_ensemble(jprob, jalg, u0s=jnp.asarray(u0s),
                                ps=jnp.asarray(ps))
    tsol = tnls.solve_ensemble(
        tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0), talg,
        u0s=_t(u0s), ps=_t(ps))
    assert tsol.counters["ensemble_route"] == "lockstep"
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsols.u),
                               rtol=1e-10, atol=0)
    stats, codes = _stats_of_jax_lone(
        lambda i: jprob.remake(u0=jnp.asarray(u0s[i]),
                               p=jnp.asarray(ps[i])), jalg, len(ps))
    assert tsol.retcode.tolist() == codes
    _same_stats_as_jax(engine, tsol, stats,
                       [(u[0], p) for u, p in zip(u0s, ps)])


def test_ensemble_problem_matches_jax():
    """EnsembleProblem(prob, prob_func) with trajectories=5 runs one
    lockstep batch."""
    jbase = jnls.NonlinearProblem(lambda u, p: u ** 2 - p,
                                  jnp.array([1.0]), 2.0)
    jsol = jnls.solve(jnls.EnsembleProblem(
        jbase, prob_func=lambda prob, i: prob.remake(p=jnp.asarray(i + 1.0))),
        jnls.NewtonRaphson(), trajectories=5)
    tsol = tnls.solve(tnls.EnsembleProblem(
        tnls.NonlinearProblem(lambda u, p: u ** 2 - p, _t([1.0]), 2.0),
        prob_func=lambda prob, i: prob.remake(p=_t(i + 1.0))),
        tnls.NewtonRaphson(), trajectories=5)
    assert tsol.counters["ensemble_route"] == "lockstep"
    assert tsol.u.shape == (5, 1)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               rtol=1e-10, atol=0)
    stats, codes = _stats_of_jax_lone(
        lambda i: jbase.remake(p=jnp.asarray(i + 1.0)),
        jnls.NewtonRaphson(), 5)
    assert tsol.retcode.tolist() == codes
    for k in STATS:
        assert getattr(tsol.stats, k).tolist() == stats[k], k


@pytest.mark.parametrize("engine", ["newton", "trust_region_fan",
                                    "levenberg_marquardt"])
def test_p23_9_matches_jax(engine):
    """The 23-problem #9 (10 unknowns) from three seeded starts: roots
    within 1e-10 and NLStats equal to the JAX package's lone solves."""
    tp, jp = TP23[8], JP23[8]
    rng = np.random.default_rng(11)
    u0s = tp.start[None, :] * (1.0 + rng.standard_normal((3, tp.start.size)))
    jalg, talg = JAX_ENGINES[engine](jnls), JAX_ENGINES[engine](tnls)
    tsol = tnls.solve_ensemble(tnls.NonlinearProblem(tp.f, _t(tp.start)),
                               talg, u0s=_t(u0s))
    assert tsol.counters["ensemble_route"] == "lockstep"
    jrows = [jnls.solve(jnls.NonlinearProblem(jp.f, jnp.asarray(u)), jalg)
             for u in u0s]
    np.testing.assert_allclose(tsol.u.numpy(),
                               np.stack([np.asarray(r.u) for r in jrows]),
                               rtol=1e-10, atol=1e-12)
    assert tsol.retcode.tolist() == [int(r.retcode) for r in jrows]
    _same_stats_as_jax(engine, tsol, {
        k: [int(getattr(r.stats, k)) for r in jrows] for k in STATS})


# the options and engines the batch does not take: trajectory by
# trajectory, each row its lone solve

LONE = {
    "gmres": (lambda: tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres")), {}),
    "forcing": (lambda: tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres"),
        forcing=tnls.EisenstatWalkerForcing()), {}),
    "pseudo_transient": (lambda: tnls.PseudoTransient(), {}),
    "trust_region_nocedalwright": (lambda: tnls.TrustRegion(
        radius_update_scheme="nocedalwright"), {}),
    "dfsane": (lambda: tnls.DFSane(), {}),
    "anderson": (lambda: tnls.AndersonAcceleration(), {}),
    "limited_memory_broyden": (lambda: tnls.LimitedMemoryBroyden(), {}),
    "broyden_linesearch": (lambda: tnls.Broyden(
        linesearch=tnls.LiFukushimaLineSearch()), {}),
    "klement_true_jacobian": (lambda: tnls.Klement(
        init_jacobian="true_jacobian"), {}),
    "robust_multi_newton": (lambda: tnls.RobustMultiNewton(), {}),
    "trace": (lambda: tnls.NewtonRaphson(), {"store_trace": True}),
}


@pytest.mark.parametrize("name", list(LONE))
def test_options_outside_the_batch_take_the_lone_route(name):
    make, kw = LONE[name]
    prob, _, ps, _ = _quadratic_case()
    ps = ps[:2]
    alg = make()
    sol = tnls.solve_ensemble(prob, alg, ps=ps, **kw)
    assert sol.counters["ensemble_route"] == "lone"
    _assert_rows_are_lone_solves(prob, alg, None, ps, kw, sol)


def test_bounds_and_sparsity_take_the_lone_route():
    prob, _, ps, _ = _quadratic_case()
    bounded = tnls.NonlinearProblem(quadratic, _t([1.0]), _t(2.0), lb=0.0)
    assert tnls.solve_ensemble(bounded, tnls.NewtonRaphson(), ps=ps[:2]) \
        .counters["ensemble_route"] == "lone"
    sparse = brusselator.make_problem(4, device="cpu", with_sparsity=True)
    ps2 = sparse.p[None, :].repeat(2, 1)
    sol = tnls.solve_ensemble(sparse, tnls.NewtonRaphson(), ps=ps2)
    assert sol.counters["ensemble_route"] == "lone"
    assert bool(sol.success.all())


def test_default_ladder_matches_jax():
    """``tests/test_ensemble_checkpoint.py``'s ensemble with the default
    polyalgorithm: one lockstep batch of the ladder."""
    ps = np.array([2.0, 5.0])
    jprob = jnls.NonlinearProblem(quadratic, jnp.array([1.0]), 2.0)
    jsols = jnls.solve_ensemble(jprob, ps=jnp.asarray(ps))
    tsol = tnls.solve_ensemble(
        tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0), ps=_t(ps))
    assert tsol.counters["ensemble_route"] == "lockstep"
    assert tsol.retcode.tolist() == [1, 1]
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsols.u),
                               rtol=1e-10, atol=0)
    stats, codes = _stats_of_jax_lone(
        lambda i: jprob.remake(p=jnp.asarray(ps[i])), None, len(ps))
    assert tsol.retcode.tolist() == codes
    _same_stats_as_jax("default_ladder", tsol, stats)


def test_simple_tier_names_its_route():
    prob, _, ps, _ = _quadratic_case()
    sol = tnls.solve_ensemble(prob, tnls.SimpleNewtonRaphson(), ps=ps)
    assert sol.counters["ensemble_route"] == "lockstep"

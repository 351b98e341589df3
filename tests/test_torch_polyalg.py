"""The port's polyalgorithms against the JAX package's, f64 on the CPU:
the rung that wins, the best-residual fallback when every rung fails,
``FastShortcutNLLSPolyalg`` (the default for least squares) on the 8 NLLS
classics, the default algorithm on the dense Brusselator at N=8 and 16,
the ladders' shapes, the warm-restart start hint, the dispatch of user
classes, and the complex ladder on a complex state."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.models.nlls_problems import NLLS_PROBLEMS as JCASES
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.models.nlls_problems import \
    NLLS_PROBLEMS as TCASES
from nonlinearsolve_tpu_torch.solvers import polyalg as tpa

torch.set_num_threads(1)

SSQ_TOL = 1e-12          # tests/test_torch_nlls.py's bound


def _quad(u, p):
    return u ** 2 - p


def _rung_names(alg):
    return [(a.name, getattr(getattr(a, "trustregion", None), "method",
                             None), type(getattr(a, "linesearch", None))
             .__name__) for a in alg.algs]


@pytest.mark.parametrize("make", [
    lambda m: m.FastShortcutNonlinearPolyalg(),
    lambda m: m.FastShortcutNonlinearPolyalg(u0_len=25),
    lambda m: m.FastShortcutNonlinearPolyalg(u0_len=26),
    lambda m: m.FastShortcutNonlinearPolyalg(must_use_jacobian=True),
    lambda m: m.FastShortcutNonlinearPolyalg(complex_eltype=True),
    lambda m: m.FastShortcutNonlinearPolyalg(complex_eltype=True,
                                             must_use_jacobian=True),
    lambda m: m.RobustMultiNewton(), lambda m: m.FastShortcutNLLSPolyalg()],
    ids=["default", "u0_len-25", "u0_len-26", "must_use_jacobian",
         "complex", "complex-jacobian", "robust", "nlls"])
def test_ladders_match_jax(make):
    j, t = make(jnls), make(tnls)
    assert (j.name, j.start_index) == (t.name, t.start_index)
    assert _rung_names(j) == _rung_names(t)


def test_default_ladder_starts_at_broyden_at_every_size():
    for n in (2, 25, 2048):
        prob = tnls.NonlinearProblem(_quad, torch.ones(n, dtype=torch.float64),
                                     2.0)
        sol = tnls.solve(prob)
        assert sol.counters["rungs"][0][0] == 0


@pytest.mark.parametrize("case", ["broyden", "newton", "trust_region"])
def test_winner_is_the_first_rung_that_succeeds(case):
    """``winner`` is the first rung (from start_index) whose own solve
    succeeds — each rung run alone in the JAX package decides which."""
    if case == "broyden":
        f, u0, p, make = _quad, [1.0, 1.0], 2.0, \
            lambda m: m.FastShortcutNonlinearPolyalg()
    elif case == "newton":
        f, u0, p, make = _quad, [1.0, 1.0], 2.0, \
            lambda m: m.FastShortcutNonlinearPolyalg(u0_len=2)
    else:
        f, u0, p, make = (lambda u, p: u ** 3 - 2 * u + 2), [0.0], None, \
            lambda m: m.FastShortcutNonlinearPolyalg()
    jalg = make(jnls)
    want = -1
    for idx, sub in list(enumerate(jalg.algs))[jalg.start_index - 1:]:
        s = jnls.solve(jnls.NonlinearProblem(f, jnp.asarray(u0), p), sub)
        if jnls.ReturnCode.successful(int(s.retcode)):
            want = idx
            break
    sol = tnls.solve(tnls.NonlinearProblem(
        f, torch.tensor(u0, dtype=torch.float64), p), make(tnls))
    assert sol.counters["winner"] == want
    assert [r[0] for r in sol.counters["rungs"]] == \
        list(range(jalg.start_index - 1, want + 1))
    jsol = jnls.solve(jnls.NonlinearProblem(f, jnp.asarray(u0), p),
                      make(jnls))
    assert int(sol.retcode) == int(jsol.retcode)


def test_every_rung_fails_returns_the_best_residual():
    """u² + 1 has no real root: every rung fails, and the result is the
    iterate with the smallest finite ‖f‖₂ over the rungs (the first on a
    tie), with that rung's retcode — the JAX package's result."""
    def f(u, p):
        return u ** 2 + 1.0

    jsol = jnls.solve(jnls.NonlinearProblem(f, jnp.array([1.0, 0.5])))
    tsol = tnls.solve(tnls.NonlinearProblem(
        f, torch.tensor([1.0, 0.5], dtype=torch.float64)))
    assert not tsol.success and tsol.counters["winner"] == -1
    assert len(tsol.counters["rungs"]) == 6
    assert not jnls.ReturnCode.successful(int(jsol.retcode))
    # the rule, on the port's own rungs
    alg = tnls.FastShortcutNonlinearPolyalg()
    best, code = np.inf, None
    for sub in alg.algs:
        s = tnls.solve(tnls.NonlinearProblem(
            f, torch.tensor([1.0, 0.5], dtype=torch.float64)), sub)
        r = float(torch.linalg.vector_norm(s.resid))
        if np.isfinite(r) and r < best:
            best, code = r, s.retcode
    assert float(torch.linalg.vector_norm(tsol.resid)) == best
    assert tsol.retcode == code
    # several rungs end at u ≈ 1e-9, where f is [1, 1] to the last bit:
    # which of them is first on the tie (and so the retcode) is rounding's,
    # so the JAX package is matched by the residual and the iterate
    np.testing.assert_allclose(float(torch.linalg.vector_norm(tsol.resid)),
                               float(jnp.linalg.norm(jsol.resid)),
                               rtol=1e-12)
    assert np.abs(tsol.u.numpy() - np.asarray(jsol.u)).max() < 1e-6


def test_stats_are_summed_over_the_rungs():
    def f(u, p):
        return u ** 2 + 1.0

    prob = tnls.NonlinearProblem(f, torch.tensor([1.0], dtype=torch.float64))
    sol = tnls.solve(prob, maxiters=20)
    total = {k: 0 for k in ("nf", "njacs", "nsteps", "nsolve", "nfactors")}
    for sub in tnls.FastShortcutNonlinearPolyalg().algs:
        s = tnls.solve(prob, sub, maxiters=20)
        for k in total:
            total[k] += getattr(s.stats, k)
    assert vars(sol.stats) == total
    assert [r[2] for r in sol.counters["rungs"]] == [20] * 6


@pytest.mark.parametrize("case", range(len(TCASES)),
                         ids=[c[0] for c in TCASES])
def test_nlls_default_against_jax(case):
    """No algorithm on a least-squares problem: FastShortcutNLLSPolyalg,
    compared by the sum of squares (ROADMAP C: the iterate and the count
    at a nonzero-residual minimum are rounding knife-edges)."""
    jc, tc = JCASES[case], TCASES[case]
    jsol = jnls.solve(jnls.NonlinearLeastSquaresProblem(
        jc[1], jnp.asarray(jc[2])), maxiters=1000)
    tsol = tnls.solve(tnls.NonlinearLeastSquaresProblem(
        tc[1], torch.tensor(tc[2])), maxiters=1000)
    jssq = float(jnp.sum(jnp.square(jsol.resid)))
    tssq = float((tsol.resid ** 2).sum())
    assert int(tsol.retcode) == int(jsol.retcode)
    assert abs(tssq - jssq) <= SSQ_TOL * max(1.0, jssq)
    assert tsol.counters["rungs"][0][0] == 0


def _brusselator_default(N):
    jprob = jbru.make_problem(N, jnp.float64)
    tprob = tbru.make_problem(N, torch.float64, device="cpu")
    jsol = jnls.solve(jprob, abstol=1e-10)
    tsol = tnls.solve(tprob, abstol=1e-10)
    assert tsol.success and int(jsol.retcode) == int(tsol.retcode)
    ju = np.asarray(jsol.u)
    assert np.abs(tsol.u.numpy() - ju).max() <= 1e-10 * max(
        np.abs(ju).max(), 1.0)
    # Broyden and Klement fail (Klement after its 1000 steps); Newton wins
    assert tsol.counters["winner"] == 2
    assert [r[:2] for r in tsol.counters["rungs"]][1:] == [(1, 3), (2, 1)]
    return jprob, tprob, jsol, tsol


def _stats(sol):
    return {k: int(getattr(sol.stats, k)) for k in ("nsteps", "nf", "njacs")}


@pytest.mark.parametrize("N", [8, 16])
def test_default_on_dense_brusselator_matches_jax(N):
    """make_problem(N), f64: the default ladder — Broyden and Klement fail
    (Klement after its 1000 steps), NewtonRaphson succeeds in 4 steps —
    with the JAX package's retcode, winner and root.  The Broyden rung
    diverges (|f| 1e27 within 20 steps) and the two runs part at the
    rounding level (at N=8 they agree to 1e-11 through step 8, then part
    by a factor of about 40 a step): whether the run overflows (Unstable)
    or stays finite and stalls, and when, is rounding's — in the port it
    moves with the number of BLAS threads (N=16: Unstable after 25 steps
    with the default threads, Stalled after 58 with one).  So the Broyden
    rung is held to failing, and the rungs after it to the JAX package's
    counts: its ladder's total less its Broyden alone."""
    jprob, tprob, jsol, tsol = _brusselator_default(N)
    jb = jnls.solve(jprob, jnls.Broyden(), abstol=1e-10)
    tb = tnls.solve(tprob, tnls.Broyden(), abstol=1e-10)
    assert not jnls.ReturnCode.successful(int(jb.retcode))
    assert tsol.counters["rungs"][0][2] == tb.stats.nsteps
    assert {k: v - getattr(tb.stats, k) for k, v in _stats(tsol).items()} \
        == {k: v - int(getattr(jb.stats, k)) for k, v in _stats(jsol).items()}


@pytest.mark.parametrize("name,flat_index,edge", [
    ("Broyden", 1304, (6, 53)), ("LimitedMemoryBroyden", 1046, (5, 31))])
def test_dense_brusselator_n32_engines_are_knife_edges_in_jax(
        name, flat_index, edge):
    """chip_smoke.py phase 20 (c) holds Broyden and LimitedMemoryBroyden
    alone on make_problem(32) to the JAX package's retcode or to the one
    its own run gives from a start one ulp away: both runs diverge, and
    whether they overflow first is a knife-edge.  The port on the CPU
    gives the JAX package's own outcome from the start."""
    prob = jbru.make_problem(32, jnp.float64)
    base = {"Broyden": (5, 22), "LimitedMemoryBroyden": (13, 37)}[name]
    u0 = np.asarray(prob.u0).copy()
    flat = u0.reshape(-1)
    flat[flat_index] = np.nextafter(flat[flat_index], np.inf)
    alg = getattr(jnls, name)()
    jsol = jnls.solve(prob, alg, abstol=1e-10)
    assert (int(jsol.retcode), int(jsol.stats.nsteps)) == base
    moved = jnls.solve(prob.remake(u0=jnp.asarray(u0)), alg, abstol=1e-10)
    assert (int(moved.retcode), int(moved.stats.nsteps)) == edge
    tsol = tnls.solve(tbru.make_problem(32, torch.float64, device="cpu"),
                      getattr(tnls, name)(), abstol=1e-10)
    assert (int(tsol.retcode), tsol.stats.nsteps) == base


def test_refusals():
    # the simple solvers came with ROADMAP A.17: SimpleBroyden →
    # SimpleKlement head the ladder instead of raising
    ladder = tnls.FastShortcutNonlinearPolyalg(
        prefer_simplenonlinearsolve=True)
    assert [a.name for a in ladder.algs[:2]] == ["SimpleBroyden",
                                                 "SimpleKlement"]
    prob = tnls.NonlinearProblem(_quad, torch.ones(2, dtype=torch.float64),
                                 2.0)
    from nonlinearsolve_tpu_torch.core.descent import DescentCtx
    from nonlinearsolve_tpu_torch.core.termination import \
        default_termination_mode
    ctx = DescentCtx(f_flat=lambda u: _quad(u, 2.0), n_in=2, n_out=2)
    # start_hint runs since ROADMAP A.18: from rung 2 on, then wrapping
    # around to the rungs before it
    with torch.no_grad():
        carry = tpa.run_polyalg(tnls.FastShortcutNonlinearPolyalg(), ctx,
                                default_termination_mode(False), None,
                                prob.u0, 3e-13, 3e-13, 10, start_hint=2)
    assert carry.rungs[0][0] == 2 and carry.winner >= 2
    np.testing.assert_allclose(carry.u.numpy(), np.sqrt(2.0), rtol=1e-10)

    class DynamicSS:
        pass

    class Custom:
        def run_flat(self, ctx, term_cfg, u0, abstol, reltol, maxiters):
            from nonlinearsolve_tpu_torch.solvers.custom import \
                make_custom_carry
            return make_custom_carry(u0, ctx.f_flat(u0), retcode=1)

    class SimpleBroyden:
        pass

    # DynamicSS and run_flat algorithms dispatch since ROADMAP A.30: a
    # user class named like one is not DynamicSS, and one with run_flat
    # runs as an algorithm
    with pytest.raises(ValueError, match="cannot dispatch"):
        tnls.solve(prob, DynamicSS())
    sol = tnls.solve(prob, Custom())
    assert sol.retcode == tnls.ReturnCode.Success
    assert torch.equal(sol.u, prob.u0)
    # a user class named like a simple solver is not one of them
    with pytest.raises(ValueError, match="cannot dispatch"):
        tnls.solve(prob, SimpleBroyden())
    with pytest.raises(ValueError, match="cannot dispatch"):
        tnls.solve(prob, object())


def test_complex_state_meets_the_dtype_refusal():
    """A complex u0 picks the complex ladder, as in the JAX package; since
    ROADMAP A.33 the port's dense path takes complex dtypes, and the
    ladder gives the JAX package's rungs, NLStats and root."""
    from nonlinearsolve_tpu_torch.core.solve import _default_algorithm
    prob = tnls.NonlinearProblem(lambda u, p: u ** 3 - p,
                                 torch.tensor([-0.8 + 1.5j],
                                              dtype=torch.complex128), 8.0)
    alg = _default_algorithm(prob)
    assert [a.name for a in alg.algs] == ["Broyden", "Klement",
                                          "NewtonRaphson"]
    jsol = jnls.solve(jnls.NonlinearProblem(
        lambda u, p: u ** 3 - p, jnp.array([-0.8 + 1.5j], jnp.complex128),
        8.0))
    tsol = tnls.solve(prob)
    assert tsol.counters["rungs"] == [(0, int(jsol.retcode),
                                       int(jsol.stats.nsteps))]
    assert (tsol.stats.nf, tsol.stats.nsteps) == (int(jsol.stats.nf),
                                                  int(jsol.stats.nsteps))
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               rtol=1e-14)


def test_default_needs_the_card_unless_asked_for_the_cpu():
    """``solve(prob)`` runs where u0 is; with no device named the problem
    is built on the card, which raises here rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbru.make_problem(8)
    sol = tnls.solve(tbru.make_problem(4, device="cpu"))
    assert sol.u.device.type == "cpu"

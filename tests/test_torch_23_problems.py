"""The 23-problem suite (BASELINE config 2) on the port's dense solver
surface, against the JAX package's own runs, f64 on the CPU.

Each (algorithm, problem) case solves the problem's numpy start in both
packages at ``maxiters=10000`` and holds ``‖f(u*)‖∞ ≤ 1e-4`` as
``tests/test_23_problems.py`` does:

- the JAX package's outcome is its own ``CASES`` row (the broken sets
  ``BROKEN`` below, copied from that file), and the port's outcome is the
  same — so the port's broken set equals the JAX package's;
- on each problem that both solve: the same retcode, ``nsteps``, ``nf``
  and ``njacs``, and roots within rel-inf 1e-8 (``ROOT_RTOL``).  The
  cases in ``EXEMPT`` keep the root check but not the equal retcode and
  counts; each names its reason.

This file runs NewtonRaphson; ``test_torch_23_trust_region.py``
TrustRegion (simple), ``test_torch_23_lm.py`` LevenbergMarquardt,
``test_torch_23_pseudo.py`` PseudoTransient (two files: its broken
problems run all 10000 steps in both packages) and
``test_torch_23_rows.py`` the slice's other rows, in the port alone.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models.problems23 import PROBLEMS_23 as JPROBLEMS
from nonlinearsolve_tpu_torch.models.problems23 import \
    PROBLEMS_23 as TPROBLEMS

torch.set_num_threads(1)

EPS = 1e-4
MAXITERS = 10000
ROOT_RTOL = 1e-8

# (row name) -> (algorithm in either package, the JAX package's broken set
# in tests/test_23_problems.py CASES)
ROWS = {
    "NewtonRaphson": (lambda m: m.NewtonRaphson(), {1}),
    "TrustRegion": (lambda m: m.TrustRegion(), {11, 21}),
    "LevenbergMarquardt": (lambda m: m.LevenbergMarquardt(), {11, 21}),
    "PseudoTransient": (lambda m: m.PseudoTransient(alpha_initial=10.0),
                        {1, 8, 11}),
}

# Cases whose retcode and counts are exempt from equality (the root is
# still held to ROOT_RTOL).  Each is an ulp knife-edge: a one-ulp change of
# one start component (np.nextafter towards +inf) moves the JAX package's
# own (retcode, nsteps).
EXEMPT = {
    ("NewtonRaphson", 8): (
        "the objective stalls at the f64 floor near step 100, where the "
        "patience test decides: the JAX package gives (Stalled, 101) from "
        "the start and (Success, 118) with any one component one ulp up"),
    ("LevenbergMarquardt", 4): (
        "Stalled at the f64 floor: the JAX package gives (Stalled, 168); "
        "one ulp up on x[0] gives (Success, 74), on x[2] (Stalled, 165)"),
    ("LevenbergMarquardt", 12): (
        "Stalled at the f64 floor: the JAX package gives (Stalled, 110); "
        "one ulp up on x[1], x[3], x[4] gives 108, 111, 104 steps"),
    ("LevenbergMarquardt", 6): (
        "the default abstol 3e-13 sits at the Watson residual's rounding "
        "floor (|f| 0.9e-13 to 1.7e-13 at points within 1e-15 of the root, "
        "in both packages): the port lands at 3.6e-13 and stalls.  The "
        "start is 0, whose one-ulp change (5e-324) is absorbed; a change "
        "of 1e-17 in x[0], x[1] or x[5] moves the JAX package's count from "
        "32 to 117, 63 or 67 steps"),
}


def _max_resid(f, u):
    return float(np.abs(np.asarray(f(u, None))).max())


def run_case(row, index):
    """Solve problem ``index`` with the row's algorithm in both packages;
    returns (jax solution, port solution, jax ok, port ok)."""
    make, _ = ROWS[row] if row in ROWS else OTHER_ROWS[row]
    jp, tp = JPROBLEMS[index - 1], TPROBLEMS[index - 1]
    assert jp.index == tp.index == index and jp.title == tp.title
    assert np.array_equal(jp.start, tp.start)
    jsol = jnls.solve(jnls.NonlinearProblem(jp.f, jnp.asarray(jp.start)),
                      make(jnls), maxiters=MAXITERS)
    tsol = tnls.solve(tnls.NonlinearProblem(tp.f, torch.tensor(tp.start)),
                      make(tnls), maxiters=MAXITERS)
    j_ok = _max_resid(jp.f, jnp.asarray(jsol.u)) <= EPS
    t_ok = float(tp.f(tsol.u).abs().max()) <= EPS
    return jsol, tsol, j_ok, t_ok


def check_against_jax(row, index):
    _, broken = ROWS[row]
    jsol, tsol, j_ok, t_ok = run_case(row, index)
    assert j_ok == (index not in broken), "the JAX package left its row"
    assert t_ok == j_ok, f"port {'solves' if t_ok else 'fails'} #{index}"
    if not (j_ok and t_ok):
        return
    ju, tu = np.asarray(jsol.u), tsol.u.numpy()
    rel = np.abs(tu - ju).max() / max(np.abs(ju).max(), 1.0)
    assert rel <= ROOT_RTOL, rel
    if (row, index) in EXEMPT:
        return
    jst = {k: int(getattr(jsol.stats, k)) for k in ("nsteps", "nf", "njacs")}
    tst = {k: getattr(tsol.stats, k) for k in ("nsteps", "nf", "njacs")}
    assert (int(jsol.retcode), jst) == (int(tsol.retcode), tst)


# rows that only the port runs here, held to the literal broken sets of
# tests/test_23_problems.py CASES (the JAX package's own runs of them are
# that file's)
OTHER_ROWS = {
    "TrustRegion-Fan": (
        lambda m: m.TrustRegion(radius_update_scheme="fan"), {11, 21}),
    "TrustRegion-NLsolve": (
        lambda m: m.TrustRegion(radius_update_scheme="nlsolve"), {21}),
    "TrustRegion-Bastin": (
        lambda m: m.TrustRegion(radius_update_scheme="bastin"), {21}),
    "TrustRegion-Hei": (
        lambda m: m.TrustRegion(radius_update_scheme="hei"), {21}),
    "TrustRegion-Yuan": (
        lambda m: m.TrustRegion(radius_update_scheme="yuan"), {8, 11, 21}),
    "LevenbergMarquardt-Geodesic01": (
        lambda m: m.LevenbergMarquardt(alpha_geodesic=0.1), {11, 21}),
    "LevenbergMarquardt-Cholesky": (
        lambda m: m.LevenbergMarquardt(
            linsolve=m.LinearSolver(method="cholesky")), {11, 21}),
    "NewtonRaphson-BackTracking": (
        lambda m: m.NewtonRaphson(linesearch=m.BackTracking()), {21}),
}


def check_port_row(row, index):
    make, broken = OTHER_ROWS[row]
    tp = TPROBLEMS[index - 1]
    sol = tnls.solve(tnls.NonlinearProblem(tp.f, torch.tensor(tp.start)),
                     make(tnls), maxiters=MAXITERS)
    ok = float(tp.f(sol.u).abs().max()) <= EPS
    assert ok == (index not in broken)


INDICES = [tp.index for tp in TPROBLEMS]


@pytest.mark.parametrize("index", INDICES)
def test_newton_raphson_against_jax(index):
    check_against_jax("NewtonRaphson", index)


def test_problems_carry_the_jax_starts_and_titles():
    assert [(p.index, p.title) for p in TPROBLEMS] == \
        [(p.index, p.title) for p in JPROBLEMS]
    rng = np.random.default_rng(0)
    for jp, tp in zip(JPROBLEMS, TPROBLEMS):
        assert np.array_equal(jp.start, tp.start)
        x = jp.start + 0.1 * rng.standard_normal(jp.start.shape)
        want = np.asarray(jp.f(jnp.asarray(x), None))
        got = tp.f(torch.tensor(x), None).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)

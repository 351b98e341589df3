"""The 8 NLLS classics (``models/nlls_problems.py``) on the port's
GaussNewton, LevenbergMarquardt (with and without geodesic acceleration)
and TrustRegion, against the JAX package's own runs, f64 on the CPU
(``tests/test_nlls_problems.py``'s settings: maxiters 1000, the L2
termination norm of least squares).  The pairs that file skips as hard
starts (its ``BROKEN``) are compared too.

Per pair: the same retcode, and the sums of squares within 1e-12 —
absolute at a zero-residual minimum (where both are rounding noise,
below 1e-24), relative at a nonzero one (bard, overdetermined_linear).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models.nlls_problems import NLLS_PROBLEMS as JCASES
from nonlinearsolve_tpu_torch.models.nlls_problems import \
    NLLS_PROBLEMS as TCASES

torch.set_num_threads(1)

SSQ_TOL = 1e-12

ALGS = {
    "gauss_newton": lambda m: m.GaussNewton(),
    "lm": lambda m: m.LevenbergMarquardt(),
    "lm_nogeo": lambda m: m.LevenbergMarquardt(disable_geodesic=True),
    "trustregion": lambda m: m.TrustRegion(),
}


def test_fixtures_match():
    assert len(JCASES) == len(TCASES)
    rng = np.random.default_rng(0)
    for jc, tc in zip(JCASES, TCASES):
        assert jc[0] == tc[0] and jc[4] == tc[4]
        assert np.array_equal(jc[2], tc[2])
        assert (jc[3] is None) == (tc[3] is None)
        x = jc[2] + 0.1 * rng.standard_normal(jc[2].shape)
        np.testing.assert_allclose(
            tc[1](torch.tensor(x), None).numpy(),
            np.asarray(jc[1](jnp.asarray(x), None)), rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("alg", list(ALGS))
@pytest.mark.parametrize("case", range(len(TCASES)),
                         ids=[c[0] for c in TCASES])
def test_nlls_against_jax(case, alg):
    jc, tc = JCASES[case], TCASES[case]
    jsol = jnls.solve(jnls.NonlinearLeastSquaresProblem(
        jc[1], jnp.asarray(jc[2])), ALGS[alg](jnls), maxiters=1000)
    tsol = tnls.solve(tnls.NonlinearLeastSquaresProblem(
        tc[1], torch.tensor(tc[2])), ALGS[alg](tnls), maxiters=1000)
    jssq = float(jnp.sum(jnp.square(jsol.resid)))
    tssq = float((tsol.resid ** 2).sum())
    assert int(tsol.retcode) == int(jsol.retcode)
    assert abs(tssq - jssq) <= SSQ_TOL * max(1.0, jssq)
    assert tsol.resid.shape == jsol.resid.shape


@pytest.mark.parametrize("resid", [[], [0.0], [1e-3], [1.0]])
def test_empty_state_least_squares_matches_jax(resid):
    """The null-u0 path of a least-squares problem (the JAX package's
    _build_null_solution): the residual is evaluated at the empty point;
    Success when it is empty or ‖resid‖ < abstol (1e-6 by default)."""
    r = np.asarray(resid, np.float64)
    jsol = jnls.solve(jnls.NonlinearLeastSquaresProblem(
        lambda u, p: jnp.asarray(r), jnp.zeros(0)), jnls.GaussNewton())
    tsol = tnls.solve(tnls.NonlinearLeastSquaresProblem(
        lambda u, p: torch.tensor(r), torch.zeros(0, dtype=torch.float64)),
        tnls.GaussNewton())
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tsol.resid.numel() == r.size and tsol.stats.nsteps == 0
    for abstol in (1e-2, 1e-9):
        jr = jnls.solve(jnls.NonlinearLeastSquaresProblem(
            lambda u, p: jnp.asarray(r), jnp.zeros(0)), jnls.GaussNewton(),
            abstol=abstol)
        tr = tnls.solve(tnls.NonlinearLeastSquaresProblem(
            lambda u, p: torch.tensor(r),
            torch.zeros(0, dtype=torch.float64)), tnls.GaussNewton(),
            abstol=abstol)
        assert int(tr.retcode) == int(jr.retcode)

"""``ArcLengthContinuation`` against the JAX package: its cases of
``tests/test_homotopy_scc.py``, f64 on the CPU unless said.

The bend-angle control compares the angle between accepted segments in
the θ-weighted metric with fixed limits, and the corrector solves the
bordered (n+1) system; each run is held to the JAX package's retcode,
``NLStats`` and last λ, and a root within 1e-10 (f32: 1e-6), besides the
JAX test's assertions; ``test_torch_homotopy.py`` says how the default
inner is covered.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from test_torch_homotopy import (ROOT_ATOL_F32, H_cubic, H_quad,
                                 assert_same, both, t64)

torch.set_num_threads(1)

TARGET_SFOLD = 2.1038034


def arc(**kw):
    return lambda m: m.ArcLengthContinuation(inner=m.NewtonRaphson(), **kw)


def assert_same_arc(jsol, tsol, atol=1e-10):
    assert_same(jsol, tsol, atol)
    assert abs(float(tsol.original) - float(jsol.original)) <= 1e-10 * max(
        1.0, abs(float(jsol.original)))


def H_sfold(u, p, lam):
    """u³ - 3u = -3 + 6λ: folds at λ = 5/6 and 1/6."""
    return u ** 3 - 3.0 * u - (-3.0 + 6.0 * lam)


def H_slaved_j(u, p, lam):
    return jnp.array([u[0] ** 3 - 3 * u[0] - (-3 + 6 * lam),
                      u[1] - u[0] ** 2])


def H_slaved_t(u, p, lam):
    return torch.stack([u[0] ** 3 - 3 * u[0] - (-3 + 6 * lam),
                        u[1] - u[0] ** 2])


def H_pair_j(u, p, lam):
    return jnp.array([
        (1 - lam) * (u[0] - 1.0) + lam * (u[0] ** 2 + u[1] ** 2 - 2.0),
        (1 - lam) * (u[1] - 1.0) + lam * (u[0] - u[1])])


def H_pair_t(u, p, lam):
    return torch.stack([
        (1 - lam) * (u[0] - 1.0) + lam * (u[0] ** 2 + u[1] ** 2 - 2.0),
        (1 - lam) * (u[1] - 1.0) + lam * (u[0] - u[1])])


def test_homotopy_cubic_arclength():
    jsol, tsol = both(H_cubic, [0.0], jnp.array(3.0), arc())
    assert_same_arc(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 1.0) <= 1e-8
    port = tnls.solve(tnls.HomotopyProblem(H_cubic, t64([0.0]), t64(3.0)),
                      tnls.ArcLengthContinuation())
    assert port.success and abs(float(port.u[0]) - 1.0) <= 1e-8


def test_arclength_defaults_and_validation():
    j, t = jnls.ArcLengthContinuation(), tnls.ArcLengthContinuation()
    assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)} == \
        {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    alg2 = tnls.ArcLengthContinuation(inner=tnls.SimpleNewtonRaphson(),
                                      initial_step_factor=0.05,
                                      max_angle=np.pi / 4, maxsteps=500,
                                      theta=0.3)
    assert alg2.maxsteps == 500 and alg2.theta == pytest.approx(0.3)
    for bad in [dict(initial_step_factor=0.0), dict(initial_step_factor=1.5),
                dict(min_ds=0.0), dict(max_step_factor=0.0),
                dict(max_step_factor=2.0), dict(expand_factor=0.5),
                dict(expand_threshold=0), dict(max_angle=0.0),
                dict(max_angle=4.0), dict(maxsteps=0),
                dict(predictor="bogus"), dict(predictor="constant"),
                dict(theta=0.0), dict(theta=1.0), dict(theta=-0.5),
                dict(theta=1.5), dict(tracking_maxiters=0)]:
        with pytest.raises(ValueError):
            jnls.ArcLengthContinuation(**bad)
        with pytest.raises(ValueError):
            tnls.ArcLengthContinuation(**bad)


def test_arclength_monotone_matches_sweep():
    jsol, tsol = both(H_quad, [4.0], jnp.asarray(4.0), arc())
    assert_same_arc(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 2.0) <= 1e-6
    assert abs(float(tsol.u[0]) ** 2 - 4.0) < 1e-8
    sweep = tnls.solve(tnls.HomotopyProblem(H_quad, t64([4.0]), t64(4.0)),
                       tnls.HomotopySweep(inner=tnls.NewtonRaphson()))
    assert abs(float(tsol.u[0]) - float(sweep.u[0])) <= 1e-6
    jd, td = both(H_quad, [1.0], jnp.asarray(4.0), arc(),
                  prob_kw=dict(lambdaspan=(1.0, 0.0)))
    assert_same_arc(jd, td)
    assert td.success and abs(float(td.u[0]) - 4.0) <= 1e-6
    port = tnls.solve(tnls.HomotopyProblem(H_quad, t64([4.0]), t64(4.0)),
                      tnls.ArcLengthContinuation())
    assert port.success and abs(float(port.u[0]) - 2.0) <= 1e-6


@pytest.mark.parametrize("predictor", ["secant", "tangent"])
def test_arclength_s_fold_connected_branch(predictor):
    """Both predictors round the double fold to the upper-sheet root."""
    jsol, tsol = both(H_sfold, [-TARGET_SFOLD], None,
                      arc(predictor=predictor))
    assert_same_arc(jsol, tsol)
    u = float(tsol.u[0])
    assert tsol.success and abs(u - TARGET_SFOLD) <= 1e-4
    assert abs(u ** 3 - 3 * u - 3.0) < 1e-6


def test_arclength_tangent_theta():
    """``test_arclength_tangent_matches_secant_and_theta``'s θ = 0.8."""
    jsol, tsol = both(H_sfold, [-TARGET_SFOLD], None,
                      arc(predictor="tangent", theta=0.8))
    assert_same_arc(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - TARGET_SFOLD) <= 1e-4


def test_arclength_tangent_2d_slaved_component():
    jsol, tsol = both(H_slaved_j, [-TARGET_SFOLD, TARGET_SFOLD ** 2], None,
                      arc(predictor="tangent"), Ht=H_slaved_t)
    assert_same_arc(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - TARGET_SFOLD) <= 1e-4
    assert abs(float(tsol.u[1]) - float(tsol.u[0]) ** 2) <= 1e-6


def test_arclength_float32_and_multidim():
    j32, t32 = both(H_quad, [4.0], np.float32(4.0), arc(),
                    pt=torch.tensor(4.0, dtype=torch.float32),
                    dtype=np.float32,
                    prob_kw=dict(lambdaspan=(np.float32(0), np.float32(1))))
    assert_same(j32, t32, atol=ROOT_ATOL_F32)
    assert t32.success and t32.u.dtype == torch.float32
    assert abs(float(t32.u[0]) - 2.0) <= 1e-4
    j2, t2 = both(H_pair_j, [1.0, 1.0], None, arc(), Ht=H_pair_t)
    assert_same_arc(j2, t2)
    assert t2.success
    np.testing.assert_allclose(t2.u.numpy(), [1.0, 1.0], atol=1e-6)


def H_circle(u, p, lam):
    return u ** 2 + (lam - 0.5) ** 2 - 0.25


def test_arclength_unreachable_target_fails_finite():
    jsol, tsol = both(H_circle, [0.0], None, arc(maxsteps=200),
                      prob_kw=dict(lambdaspan=(0.0, 2.0)))
    assert_same_arc(jsol, tsol)
    assert not tsol.success and torch.isfinite(tsol.u).all()
    js, ts = both(H_sfold, [-TARGET_SFOLD], None, arc(maxsteps=2))
    assert_same_arc(js, ts)
    assert not ts.success and torch.isfinite(ts.u).all()

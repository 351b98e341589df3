"""``KantorovichHomotopy`` against the JAX package: its cases of
``tests/test_homotopy_scc.py``, f64 on the CPU unless said.

The step control reads Θ, the contraction of one Newton step at the
predictor point (a dense forward Jacobian and an LU), and compares it with
fixed limits: each run is held to the JAX package's retcode and
``NLStats`` and a root within 1e-10 (f32: 1e-6), besides the JAX test's
assertions; ``test_torch_homotopy.py`` says how the default inner is
covered.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from test_torch_homotopy import (ROOT_ATOL_F32, H_cubic, H_tracked,
                                 assert_same, both, t64)

torch.set_num_threads(1)


def kant(**kw):
    return lambda m: m.KantorovichHomotopy(inner=m.NewtonRaphson(), **kw)


def H_cbrt(u, p, lam):
    return u ** 3 - (1 + lam)


def test_homotopy_cubic_kantorovich():
    jsol, tsol = both(H_cubic, [0.0], jnp.array(3.0), kant())
    assert_same(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 1.0) <= 1e-8
    port = tnls.solve(tnls.HomotopyProblem(H_cubic, t64([0.0]), t64(3.0)),
                      tnls.KantorovichHomotopy())
    assert port.success and abs(float(port.u[0]) - 1.0) <= 1e-8


@pytest.mark.parametrize("abstol", [1e-6, 1e-9, 1e-12])
def test_landing_repolish_tolerance_kantorovich(abstol):
    jsol, tsol = both(H_tracked, [1.2], 1.5, kant(), abstol=abstol)
    assert_same(jsol, tsol)
    assert tsol.success
    assert float(tsol.resid.abs().max()) < 10 * abstol


@pytest.mark.parametrize("loose", [1e-2, 1e-4])
def test_loose_tracking_landing_exempt_kantorovich(loose):
    jsol, tsol = both(H_tracked, [1.2], 1.5, kant(tracking_abstol=loose))
    assert_same(jsol, tsol)
    assert tsol.success and float(tsol.resid.abs().max()) < 1e-10


def test_kantorovich_defaults_and_validation():
    j, t = jnls.KantorovichHomotopy(), tnls.KantorovichHomotopy()
    assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)} == \
        {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    assert t.predictor == "constant" and t.predictor_order == 1 and t.strict
    assert tnls.KantorovichHomotopy(predictor="secant").predictor_order == 2
    assert tnls.KantorovichHomotopy(predictor="secant",
                                    predictor_order=3).predictor_order == 3
    for bad in [dict(nsteps=0), dict(initial_step_factor=0),
                dict(min_dlam=0), dict(max_step_factor=2), dict(qmin=1),
                dict(qmax=0.9), dict(theta_min=0.6, theta_bar=0.5),
                dict(theta_bar=0.96), dict(gamma=1),
                dict(predictor="quadratic"), dict(predictor_order=0),
                dict(expand_quality=0), dict(tracking_maxiters=0),
                dict(tracking_abstol=0), dict(maxsteps=0)]:
        with pytest.raises(ValueError):
            jnls.KantorovichHomotopy(**bad)
        with pytest.raises(ValueError):
            tnls.KantorovichHomotopy(**bad)


@pytest.mark.parametrize("inner", ["NewtonRaphson", "SimpleNewtonRaphson"])
def test_kantorovich_solves_and_variants(inner):
    """The cube root of 2 with each inner (the port also with the
    default); a decreasing span; an f32 problem stays f32."""
    jsol, tsol = both(H_cbrt, [1.0], None, lambda m: m.KantorovichHomotopy(
        inner=getattr(m, inner)()))
    assert_same(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 2.0 ** (1 / 3)) <= 1e-9
    port = tnls.solve(tnls.HomotopyProblem(H_cbrt, t64([1.0])),
                      tnls.KantorovichHomotopy())
    assert port.success and abs(float(port.u[0]) - 2.0 ** (1 / 3)) <= 1e-9
    if inner != "NewtonRaphson":
        return
    jd, td = both(lambda u, p, lam: u - (1 + lam), [2.0], None, kant(),
                  prob_kw=dict(lambdaspan=(1.0, 0.0)))
    assert_same(jd, td)
    assert td.success and abs(float(td.u[0]) - 1.0) <= 1e-10
    j32, t32 = both(lambda u, p, lam: u ** 2 - (1 + lam), [1.0], None,
                    kant(), dtype=np.float32,
                    prob_kw=dict(lambdaspan=(np.float32(0), np.float32(1))))
    assert_same(j32, t32, atol=ROOT_ATOL_F32)
    assert t32.success and t32.u.dtype == torch.float32
    assert abs(float(t32.u[0]) - np.sqrt(2.0)) <= 2e-5

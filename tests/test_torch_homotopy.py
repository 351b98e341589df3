"""The natural-parameter sweep (``HomotopySweep``, ``SimpleHomotopySweep``)
against the JAX package: the sweep cases of ``tests/test_homotopy_scc.py``,
f64 on the CPU unless said.

Each case runs the same ``HomotopyProblem`` through both packages and
holds the port to the JAX package's retcode and ``NLStats`` and to a root
within 1e-10 (``ROOT_ATOL``; f32: 1e-6), besides the JAX test's own
assertions.  Where the JAX test runs the default inner corrector (the
FastShortcut polyalgorithm, about 10 s of JAX compile a plan), both
packages run ``NewtonRaphson()`` as the inner solver here, and the port
alone runs the default inner against the JAX test's assertions; the
default inner is held against the JAX package in
``test_torch_homotopy_default.py``.  ``test_torch_homotopy_kantorovich.py``
and ``test_torch_homotopy_arclength.py`` hold the other methods,
``test_torch_homotopy_effort.py`` the tracking and step caps.  The
residuals are module-level functions, so the JAX package compiles each
(function, algorithm) plan once.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls

torch.set_num_threads(1)

ROOT_ATOL = 1e-10
ROOT_ATOL_F32 = 1e-6
STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def t64(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def both(H, u0, p=None, alg=None, *, Ht=None, pt="same", prob_kw=None,
         dtype=np.float64, **kw):
    """The same homotopy through both packages: ``alg(module)`` builds
    each package's algorithm; ``Ht`` the port's residual where it needs
    torch functions; ``pt`` the port's p (default: p as a tensor, or as
    given when it is None or a float)."""
    prob_kw = prob_kw or {}
    u0 = np.asarray(u0, dtype=dtype)
    if isinstance(pt, str):
        pt = (torch.as_tensor(np.array(p, dtype=dtype))
              if isinstance(p, (jnp.ndarray, np.ndarray)) else p)
    jsol = jnls.solve(jnls.HomotopyProblem(H, jnp.asarray(u0), p, **prob_kw),
                      None if alg is None else alg(jnls), **kw)
    tsol = tnls.solve(tnls.HomotopyProblem(Ht or H, torch.as_tensor(u0), pt,
                                           **prob_kw),
                      None if alg is None else alg(tnls), **kw)
    return jsol, tsol


def assert_same(jsol, tsol, atol=ROOT_ATOL):
    """The JAX package's retcode and NLStats; the root within ``atol``."""
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tuple(getattr(tsol.stats, k) for k in STATS) == tuple(
        int(getattr(jsol.stats, k)) for k in STATS)
    np.testing.assert_allclose(tsol.u.detach().numpy(), np.asarray(jsol.u),
                               rtol=0, atol=atol)


def nr_inner(**kw):
    return lambda m: m.HomotopySweep(inner=m.NewtonRaphson(), **kw)


def H_cubic(u, p, lam):
    return lam * (u ** 3 + 2.0 * u - p) + (1 - lam) * (u - 0.5)


def H_quad(u, p, lam):
    return (1 - lam) * (u - p) + lam * (u ** 2 - p)


def H_tracked(u, q, lam):
    return u ** 3 - u - lam * q


def H_fold(u, p, lam):
    return (1 - lam) * u + lam * (u ** 2 + 1.0)


def test_homotopy_cubic_sweep():
    """``test_homotopy_cubic[sweep]``: the root 1 of u³ + 2u = 3."""
    jsol, tsol = both(H_cubic, [0.0], jnp.array(3.0), nr_inner())
    assert_same(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 1.0) <= 1e-8
    port = tnls.solve(tnls.HomotopyProblem(H_cubic, t64([0.0]), t64(3.0)),
                      tnls.HomotopySweep())
    assert port.success and abs(float(port.u[0]) - 1.0) <= 1e-8


def test_homotopy_zero_width_span():
    jsol, tsol = both(H_cubic, [0.4], jnp.array(3.0), nr_inner(),
                      prob_kw=dict(lambdaspan=(1.0, 1.0)))
    assert_same(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 1.0) <= 1e-8
    assert float(tsol.original) == 1.0


def test_homotopy_anchor_failure():
    def H(u, p, lam):
        return lam * (u - 1.0) + (1 - lam) * (u ** 2 + 1.0)
    jsol, tsol = both(H, [0.0], None, nr_inner())
    assert_same(jsol, tsol)
    assert not tsol.success
    assert not tnls.solve(tnls.HomotopyProblem(H, t64([0.0])),
                          tnls.HomotopySweep()).success


def test_simple_homotopy_sweep():
    jsol, tsol = both(H_cubic, [0.0], jnp.array(3.0),
                      lambda m: m.SimpleHomotopySweep())
    assert_same(jsol, tsol)
    assert isinstance(tnls.SimpleHomotopySweep().inner,
                      tnls.SimpleNewtonRaphson)
    assert tsol.success and abs(float(tsol.u[0]) - 1.0) <= 1e-6


@pytest.mark.parametrize("abstol", [1e-6, 1e-9, 1e-12])
def test_landing_repolish_tolerance_sweep(abstol):
    jsol, tsol = both(H_tracked, [1.2], 1.5, nr_inner(), abstol=abstol)
    assert_same(jsol, tsol)
    assert tsol.success
    assert float(tsol.resid.abs().max()) < 10 * abstol


@pytest.mark.parametrize("loose", [1e-2, 1e-4])
def test_loose_tracking_landing_exempt(loose):
    jsol, tsol = both(H_tracked, [1.2], 1.5, nr_inner(tracking_abstol=loose))
    assert_same(jsol, tsol)
    assert tsol.success and float(tsol.resid.abs().max()) < 1e-10
    port = tnls.solve(tnls.HomotopyProblem(H_tracked, t64([1.2]), 1.5),
                      tnls.HomotopySweep(tracking_abstol=loose))
    assert port.success and float(port.resid.abs().max()) < 1e-10


def test_user_tolerance_shadows_loose_tracking():
    """An explicit abstol switches the loose interior tolerance off: the
    run does at least as many residual evaluations and lands tighter."""
    alg = nr_inner(tracking_abstol=1e-2, nsteps=8)
    j_loose, t_loose = both(H_tracked, [1.2], 1.5, alg)
    j_user, t_user = both(H_tracked, [1.2], 1.5, alg, abstol=1e-12)
    assert_same(j_loose, t_loose)
    assert_same(j_user, t_user)
    assert t_loose.success and t_user.success
    assert t_user.stats.nf >= t_loose.stats.nf
    assert float(t_user.resid.abs().max()) < 1e-11


def H_tanh_j(u, p, lam):
    return jnp.tanh(3.0 * u) - u + lam * p


def H_tanh_t(u, p, lam):
    return torch.tanh(3.0 * u) - u + lam * p


def test_user_maxiters_shadows_tracking_budget():
    jsol, tsol = both(H_tanh_j, [0.1], 0.4,
                      nr_inner(tracking_maxiters=1, nsteps=4), Ht=H_tanh_t,
                      maxiters=200)
    assert_same(jsol, tsol)
    assert tsol.success and float(tsol.resid.abs().max()) < 1e-9


def test_sweep_constructor_defaults_and_validation():
    """The fields and defaults of the JAX package's config; the same
    construction errors."""
    import dataclasses
    j, t = jnls.HomotopySweep(), tnls.HomotopySweep()
    assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)} == \
        {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    alg2 = tnls.HomotopySweep(inner=tnls.SimpleNewtonRaphson(), nsteps=20,
                              adaptive=False, min_dlam=1e-4,
                              max_step_factor=0.25, expand_factor=1.5,
                              expand_threshold=3, predictor="constant")
    assert alg2.nsteps == 20 and not alg2.adaptive
    assert tnls.HomotopySweep(expand_factor=1).expand_factor == 1
    assert tnls.HomotopySweep(expand_quality=float("inf")).expand_quality \
        == float("inf")
    for bad in [dict(adaptive=False), dict(nsteps=0),
                dict(max_step_factor=0.0), dict(max_step_factor=1.5),
                dict(expand_factor=0.5), dict(expand_threshold=0),
                dict(expand_quality=0.0), dict(expand_quality=-1.0),
                dict(predictor="tangent"), dict(initial_step_factor=0.0),
                dict(min_dlam=0.0), dict(maxsteps=0),
                dict(tracking_maxiters=0), dict(tracking_abstol=0.0)]:
        with pytest.raises(ValueError):
            jnls.HomotopySweep(**bad)
        with pytest.raises(ValueError):
            tnls.HomotopySweep(**bad)


def H_dict(u, p, lam):
    return (1 - lam) * (u - p["c"]) + lam * (u ** 2 - p["c"])


def test_sweep_p_needs_no_structure():
    jsol, tsol = both(H_dict, [4.0], {"c": jnp.asarray(4.0)}, nr_inner(),
                      pt={"c": t64(4.0)})
    assert_same(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 2.0) <= 1e-6


def H_atan_j(u, p, lam):
    return (1 - lam) * u + lam * jnp.arctan(u - 3.0)


def H_atan_t(u, p, lam):
    return (1 - lam) * u + lam * torch.atan(u - 3.0)


def test_sweep_saturating_atan_vs_cold_newton():
    jsol, tsol = both(H_atan_j, [12.0], None, nr_inner(nsteps=20),
                      Ht=H_atan_t)
    assert_same(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 3.0) <= 1e-5
    cold = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: torch.atan(u - 3.0), t64([12.0])), tnls.NewtonRaphson())
    assert not (cold.success and abs(float(cold.u[0]) - 3.0) < 1e-3)


def test_sweep_fold_fails_finite():
    jsol, tsol = both(H_fold, [0.0], None, nr_inner(min_dlam=1e-2))
    assert_same(jsol, tsol)
    assert not tsol.success and torch.isfinite(tsol.u).all()
    port = tnls.solve(tnls.HomotopyProblem(H_fold, t64([0.0])),
                      tnls.HomotopySweep(min_dlam=1e-2))
    assert not port.success and torch.isfinite(port.u).all()


def test_sweep_prob_kwargs_reach_inner_solves():
    jsol, tsol = both(H_quad, [4.0], jnp.asarray(4.0), nr_inner(min_dlam=1e-2),
                      prob_kw=dict(maxiters=1))
    assert_same(jsol, tsol)
    assert not tsol.success


def test_sweep_fixed_step_fold_fails():
    jsol, tsol = both(H_fold, [0.0], None,
                      nr_inner(adaptive=False, nsteps=10))
    assert_same(jsol, tsol)
    assert not tsol.success


def test_sweep_stall_guard_large_span():
    def H(u, p, lam):
        return u ** 2 + (lam - 1.0e9)
    jsol, tsol = both(H, [0.0], None, nr_inner(),
                      prob_kw=dict(lambdaspan=(1.0e9, 2.0e9)), maxiters=5)
    assert_same(jsol, tsol)
    assert tsol.retcode == tnls.ReturnCode.Stalled
    assert torch.isfinite(tsol.resid).all()


def test_sweep_decreasing_span():
    jsol, tsol = both(H_quad, [2.0], jnp.asarray(4.0), nr_inner(),
                      prob_kw=dict(lambdaspan=(1.0, 0.0)))
    assert_same(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 4.0) <= 1e-6


def test_sweep_float32_no_promotion():
    """λ, dλ and the step control stay in f32."""
    jsol, tsol = both(H_quad, [4.0], np.float32(4.0), nr_inner(),
                      pt=torch.tensor(4.0, dtype=torch.float32),
                      prob_kw=dict(lambdaspan=(np.float32(0),
                                               np.float32(1))),
                      dtype=np.float32)
    assert_same(jsol, tsol, atol=ROOT_ATOL_F32)
    assert tsol.success and tsol.u.dtype == torch.float32
    assert abs(float(tsol.u[0]) - 2.0) <= 1e-3


@pytest.mark.parametrize("inner", ["NewtonRaphson", "SimpleNewtonRaphson"])
def test_sweep_inner_variants(inner):
    jsol, tsol = both(H_quad, [4.0], jnp.asarray(4.0),
                      lambda m: m.HomotopySweep(inner=getattr(m, inner)()))
    assert_same(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 2.0) <= 1e-6
    port = tnls.solve(tnls.HomotopyProblem(H_quad, t64([4.0]), t64(4.0)),
                      tnls.HomotopySweep(inner=None))
    assert port.success and abs(float(port.u[0]) - 2.0) <= 1e-6


def H_branch(u, p, lam):
    return (1 - lam) * (u - 4.0) + lam * (u ** 2 - 4.0)


def test_sweep_anchor_selects_branch():
    jsol, tsol = both(H_branch, [-10.0], None, nr_inner())
    assert_same(jsol, tsol)
    assert tsol.success and abs(float(tsol.u[0]) - 2.0) <= 1e-5


def test_sweep_anchor_failure_not_stalled():
    """An unsolvable anchor fails fast with the inner code and u = u0."""
    def H(u, p, lam):
        return u ** 2 + 1.0
    jsol, tsol = both(H, [0.5], None, nr_inner(), maxiters=25)
    assert_same(jsol, tsol)
    assert not tsol.success and tsol.retcode != tnls.ReturnCode.Stalled
    assert torch.isfinite(tsol.resid).all() and float(tsol.u[0]) == 0.5


def H_linear(u, p, lam):
    return u - lam


def test_sweep_expansion_step_economy():
    j_grow, t_grow = both(H_linear, [0.0], None, nr_inner())
    j_flat, t_flat = both(H_linear, [0.0], None, nr_inner(expand_factor=1))
    assert_same(j_grow, t_grow)
    assert_same(j_flat, t_flat)
    assert t_grow.stats.nf < t_flat.stats.nf


def H_cube_path(u, p, lam):
    return u ** 3 - (1 + lam) ** 3


def test_sweep_predictor_secant_beats_constant():
    nf = {}
    for predictor in ("secant", "constant"):
        jsol, tsol = both(H_cube_path, [1.0], None,
                          nr_inner(predictor=predictor))
        assert_same(jsol, tsol)
        assert tsol.success and abs(float(tsol.u[0]) - 2.0) <= 1e-6
        nf[predictor] = tsol.stats.nf
    assert nf["secant"] < nf["constant"]


def H_turn_j(u, p, lam):
    x = u - 3.0 * jnp.tanh(20.0 * (lam - 0.5))
    return x + 2.0 * jnp.sin(x)


def H_turn_t(u, p, lam):
    x = u - 3.0 * torch.tanh(20.0 * (lam - 0.5))
    return x + 2.0 * torch.sin(x)


def test_sweep_sharp_turn_bisect_then_regrow():
    target = 3.0 * np.tanh(10.0)
    nf = {}
    for expand_factor in (2.0, 1.0):
        jsol, tsol = both(H_turn_j, [-target], None,
                          nr_inner(initial_step_factor=0.25,
                                   expand_factor=expand_factor),
                          Ht=H_turn_t, maxiters=100)
        assert_same(jsol, tsol)
        assert tsol.success and abs(float(tsol.u[0]) - target) <= 1e-6
        nf[expand_factor] = tsol.stats.nf
    assert nf[2.0] < nf[1.0]

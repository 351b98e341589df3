"""One step of each line search and of each trust-region scheme in the port
(``core/linesearch.py``, ``core/wolfe_linesearch.py``,
``core/trust_region.py``) against the JAX function, from the same
(u, δu, fu, J), f64 on the CPU.

The states are 23-problem starts (Wood and trigonometric; Brown almost
linear too for the LM trust region); J is the forward-mode Jacobian and
δu the Newton step, scaled by 1 and by 4 (so that the searches have to
backtrack).  Line
searches: the same success flag and count of f evaluations, α within
rel 1e-10 (the trials are continuous functions of merits that the two
packages round apart by ulps).  Trust regions (the seven schemes from
their own initial radius and from 50, and the LM trust region after a
geodesic step): the same accept flag and shrink counter, the new radius
within rel 1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinearsolve_tpu.core import descent as jdsc
from nonlinearsolve_tpu.core import linesearch as jls
from nonlinearsolve_tpu.core import trust_region as jtr
from nonlinearsolve_tpu.core import wolfe_linesearch as jwl
from nonlinearsolve_tpu.models.problems23 import PROBLEMS_23 as JP
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.core import damping as tdmp
from nonlinearsolve_tpu_torch.core import descent as tdsc
from nonlinearsolve_tpu_torch.core import linesearch as tls
from nonlinearsolve_tpu_torch.core import trust_region as ttr
from nonlinearsolve_tpu_torch.core import wolfe_linesearch as twl
from nonlinearsolve_tpu_torch.models.problems23 import PROBLEMS_23 as TP

torch.set_num_threads(2)

RTOL = 1e-10
LINE_SEARCHES = ["BackTracking", "LiFukushimaLineSearch",
                 "RobustNonMonotoneLineSearch", "StaticLineSearch",
                 "StrongWolfe", "HagerZhang", "MoreThuente"]


def _module(name, jax_side):
    if name in ("BackTracking", "LiFukushimaLineSearch",
                "RobustNonMonotoneLineSearch"):
        return jls if jax_side else tls
    return jwl if jax_side else twl


def _state(index, scale):
    """(u, du, fu, J) in both packages' arrays, and the residuals."""
    jp, tp = JP[index - 1], TP[index - 1]
    u = jp.start
    jf = lambda v: jp.f(v, None)                     # noqa: E731
    J = np.asarray(jax.jacfwd(jf)(jnp.asarray(u)))
    fu = np.asarray(jf(jnp.asarray(u)))
    du = -scale * np.linalg.solve(J, fu)
    return (u, du, fu, J), jf, (lambda v: tp.f(v, None))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-300)


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("index", [4, 11])
@pytest.mark.parametrize("name", LINE_SEARCHES)
def test_line_search_step(name, index, scale):
    (u, du, fu, J), jf, tf = _state(index, scale)
    jcfg = getattr(_module(name, True), name)()
    tcfg = getattr(_module(name, False), name)()
    n = u.size
    jctx = jdsc.DescentCtx(f_flat=jf, n_in=n, n_out=n,
                           is_least_squares=False)
    tctx = tdsc.DescentCtx(f_flat=tf, n_in=n, n_out=n)
    ja = [jnp.asarray(a) for a in (u, du, fu, J)]
    ta = [torch.tensor(a) for a in (u, du, fu, J)]
    jstate = jls.ls_init(jcfg, jctx, ja[2], ja[0])
    tstate = tls.ls_init(tcfg, ta[2], _backend.fetch(
        *tls.ls_init_reads(tcfg, ta[2])) if tls.ls_init_reads(
            tcfg, ta[2]) else [])
    want = jls.ls_solve(jcfg, jstate, jctx, ja[0], ja[1], ja[2], ja[3], 3)
    with torch.no_grad():
        got = tls.ls_solve(tcfg, tstate, tctx, ta[0], ta[1], ta[2], ta[3], 3)
    assert got.success == bool(want.success)
    assert got.nf == int(want.nf)
    assert _rel(got.alpha, want.alpha) <= RTOL


def test_line_searches_jl_names():
    for key, cls in (("static", twl.StaticLineSearch),
                     ("strong_wolfe", twl.StrongWolfe),
                     ("HagerZhang", twl.HagerZhang),
                     ("morethuente", twl.MoreThuente),
                     ("backtracking", tls.BackTracking)):
        assert isinstance(twl.LineSearchesJL(method=key), cls)
    assert twl.LineSearchesJL() == twl.StaticLineSearch()
    assert twl.LineSearchesJL(twl.StrongWolfe, c_2=0.5).c_2 == 0.5
    with pytest.raises(ValueError):
        twl.LineSearchesJL(method="nope")


@pytest.mark.parametrize("radius", [None, 50.0])
@pytest.mark.parametrize("index", [4, 11])
@pytest.mark.parametrize("scheme", list(ttr.SCHEMES))
def test_trust_region_step(scheme, index, radius):
    (u, _, fu, J), jf, tf = _state(index, 1.0)
    n = u.size
    jcfg = jtr.GenericTrustRegionScheme(method=scheme,
                                        initial_trust_radius=radius)
    tcfg = ttr.GenericTrustRegionScheme(method=scheme,
                                        initial_trust_radius=radius)
    jctx = jdsc.DescentCtx(f_flat=jf, n_in=n, n_out=n,
                           is_least_squares=False)
    tctx = tdsc.DescentCtx(f_flat=tf, n_in=n, n_out=n)
    ju, jfu, jJ = (jnp.asarray(a) for a in (u, fu, J))
    tu, tfu, tJ = (torch.tensor(a) for a in (u, fu, J))
    jstate = jtr.tr_init(jcfg, jctx, jfu, ju)
    with torch.no_grad():
        tstate = ttr.tr_init(tcfg, tu, _backend.fetch(
            *ttr.tr_init_reads(tcfg, tctx, tfu, tu)))
    assert _rel(tstate.trust_region, jstate.trust_region) <= RTOL
    jres, _ = jdsc.descent_solve(jdsc.Dogleg(), None, jctx, jJ, jfu, ju,
                                 trust_region=jstate.trust_region)
    jacc, _, _, jnew = jtr.tr_solve(jcfg, jstate, jctx, jJ, jfu, ju,
                                    jres.du, jres)
    with torch.no_grad():
        tres, _ = tdsc.descent_solve(tdsc.Dogleg(), None, tctx, tJ, tfu, tu,
                                     trust_region=tstate.trust_region)
        _, _, reads = ttr.tr_candidate(tcfg, tstate, tctx, tJ, tfu, tu,
                                       tres.du, tres)
        tacc, tnew = ttr.tr_update(tcfg, tstate, _backend.fetch(*reads),
                                   tres, tres.du)
    assert tacc == bool(jacc)
    assert tnew.shrink_counter == int(jnew.shrink_counter)
    assert _rel(tnew.trust_region, jnew.trust_region) <= RTOL


@pytest.mark.parametrize("index", [4, 8])
def test_levenberg_marquardt_trust_region_step(index):
    """A geodesic LM step (the damped least-squares system, its second
    solve on the same system) and the b_uphill accept test, twice: the
    first step (norm_v_old = inf) and a second one from the first's
    state."""
    (u, _, fu, J), jf, tf = _state(index, 1.0)
    n = u.size
    from nonlinearsolve_tpu.core import damping as jdmp
    jdesc = jdsc.GeodesicAcceleration(descent=jdsc.DampedNewtonDescent(
        damping=jdmp.LevenbergMarquardtDamping()))
    tdesc = tdsc.GeodesicAcceleration(descent=tdsc.DampedNewtonDescent(
        damping=tdmp.LevenbergMarquardtDamping()))
    jctx = jdsc.DescentCtx(f_flat=jf, n_in=n, n_out=n,
                           is_least_squares=False)
    tctx = tdsc.DescentCtx(f_flat=tf, n_in=n, n_out=n)
    ju, jfu, jJ = (jnp.asarray(a) for a in (u, fu, J))
    tu, tfu, tJ = (torch.tensor(a) for a in (u, fu, J))
    jcfg, tcfg = jtr.LevenbergMarquardtTrustRegion(), \
        ttr.LevenbergMarquardtTrustRegion()
    jstate = jtr.tr_init(jcfg, jctx, jfu, ju)
    tstate = ttr.tr_init(tcfg, tu, [])
    jds = jdsc.descent_init(jdesc, jctx, None, jfu, ju)
    with torch.no_grad():
        tds = tdsc.descent_init(tdesc, tctx, None, tfu, tu)
    for _ in range(2):
        jres, jds = jdsc.descent_solve(jdesc, jds, jctx, jJ, jfu, ju)
        jacc, _, _, jstate = jtr.tr_solve(jcfg, jstate, jctx, jJ, jfu, ju,
                                          jres.du, jres)
        jds = jdsc.descent_post_step(jdesc, jds, jacc & jres.success)
        with torch.no_grad():
            tres, tds = tdsc.descent_solve(tdesc, tds, tctx, tJ, tfu, tu)
            _, _, reads = ttr.tr_candidate(tcfg, tstate, tctx, tJ, tfu, tu,
                                           tres.du, tres)
            tacc, tstate = ttr.tr_update(tcfg, tstate,
                                         _backend.fetch(*reads), tres,
                                         tres.du)
            tds = tdsc.descent_post_step(tdesc, tds,
                                         tacc and bool(tres.success))
        assert tacc == bool(jacc)
        assert bool(tres.success) == bool(jres.success)
        np.testing.assert_allclose(tres.du.numpy(), np.asarray(jres.du),
                                   rtol=1e-9, atol=1e-12)
        assert _rel(tstate.loss_old, jstate.loss_old) <= RTOL
        assert _rel(tds.damping.lam, jds.damping.lam) <= RTOL


GLOBALIZATIONS = ([("linesearch", n) for n in LINE_SEARCHES]
                  + [("trustregion", m) for m in ttr.SCHEMES])


@pytest.mark.parametrize("kind,name", GLOBALIZATIONS,
                         ids=[n for _, n in GLOBALIZATIONS])
def test_each_globalization_solves_the_quickstart(kind, name):
    """NewtonRaphson with each line search, and TrustRegion with each
    radius scheme, solve the README quickstart (u² = p, p = 2) and the
    23 problems' Dennis–Schnabel system to abstol 1e-10, with the JAX
    package's retcode and root (rel 1e-10)."""
    import nonlinearsolve_tpu as jnls
    import nonlinearsolve_tpu_torch as tnls

    def alg(m):
        if kind == "trustregion":
            return m.TrustRegion(radius_update_scheme=name)
        return m.NewtonRaphson(linesearch=getattr(m, name)())

    cases = [(lambda u, p: u * u - p, np.array([1.0, 1.0]), 2.0),
             (JP[16].f, JP[16].start, None)]
    for i, (f, u0, p) in enumerate(cases):
        tf = (lambda u, p_: u * u - p_) if i == 0 else TP[16].f
        jsol = jnls.solve(jnls.NonlinearProblem(f, jnp.asarray(u0), p),
                          alg(jnls), abstol=1e-10)
        tsol = tnls.solve(tnls.NonlinearProblem(tf, torch.tensor(u0), p),
                          alg(tnls), abstol=1e-10)
        assert int(tsol.retcode) == int(jsol.retcode) == 1   # Success
        ju = np.asarray(jsol.u)
        assert np.abs(tsol.u.numpy() - ju).max() <= 1e-10 * max(
            np.abs(ju).max(), 1.0)

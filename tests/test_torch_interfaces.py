"""The iterator, traces, messages, phase timers, ``maxtime`` and the
initialization hook against the JAX package: the cases of
``tests/test_interfaces.py`` that these cover (its SciPy, SCC, homotopy
and extension-wrapper rows: ``test_torch_wrappers.py`` and
``test_torch_scc.py``), f64 on the CPU.

Solves through the iterator must give the JAX package's roots and step
counts; messages are compared by their class tag and text (the JAX
package prints its engine-site messages with ``jax.debug.print``, the
port with ``print``, both on stdout; host-site messages go to stderr in
both).  The JAX test's orbax checkpoint of the carry becomes
``torch.save`` of the port's carry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.core import verbosity as jvrb
from nonlinearsolve_tpu_torch.core import verbosity as tvrb

torch.set_num_threads(2)


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


def quadratic(u, p):
    return u * u - p


def _same_root(jsol, tsol, rtol=1e-12):
    ju, tu = np.asarray(jsol.u), tsol.u.detach().numpy()
    assert np.abs(tu - ju).max() <= rtol * max(np.abs(ju).max(), 1.0)


# ---------------------------------------------------------------------------
# the iterator
# ---------------------------------------------------------------------------

def test_iterator_step_solve():
    jc = jnls.init(jnls.NonlinearProblem(quadratic, jnp.array([1.0, 1.0]),
                                         2.0), jnls.NewtonRaphson())
    tc = tnls.init(tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0),
                   tnls.NewtonRaphson())
    jc.step()
    tc.step()
    assert tc.nsteps == jc.nsteps == 1
    np.testing.assert_allclose(tc.u.numpy(), 1.5)
    jsol, tsol = jc.solve(), tc.solve()
    assert tsol.success
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    _same_root(jsol, tsol)
    np.testing.assert_allclose(tsol.u.numpy(), np.sqrt(2.0), rtol=1e-10)


def test_iterator_equals_solve():
    """init → two steps → solve makes the operations of one solve: the
    same retcode, stats and root, bit for bit."""
    prob = tnls.NonlinearProblem(lambda u, p: u ** 3 - p,
                                 _t([3.0, 1.0, 2.0]), _t([1.0, 2.0, 3.0]))
    alg = tnls.NewtonRaphson(linesearch=tnls.BackTracking())
    ref = tnls.solve(prob, alg)
    cache = tnls.init(prob, alg)
    cache.step(2)
    sol = cache.solve()
    assert sol.retcode == ref.retcode
    assert sol.stats == ref.stats
    assert torch.equal(sol.u, ref.u) and torch.equal(sol.resid, ref.resid)


def test_iterator_warm_restart_sweep():
    jc = jnls.init(jnls.NonlinearProblem(quadratic, jnp.array([1.0]), 2.0),
                   jnls.NewtonRaphson())
    tc = tnls.init(tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0),
                   tnls.NewtonRaphson())
    jroots, troots = [], []
    for pval in [1.0, 2.0, 3.0, 4.0]:
        jc.reinit(p=jnp.asarray(pval))
        tc.reinit(p=_t(pval))
        jroots.append(float(jc.solve().u[0]))
        troots.append(float(tc.solve().u[0]))
    np.testing.assert_allclose(troots, jroots, rtol=1e-14)
    np.testing.assert_allclose(troots, np.sqrt([1.0, 2.0, 3.0, 4.0]),
                               rtol=1e-10)


@pytest.mark.parametrize("name", ["Broyden", "Klement",
                                  "LimitedMemoryBroyden"])
def test_iterator_quasi_newton(name):
    jc = jnls.init(jnls.NonlinearProblem(quadratic, jnp.array([1.0, 1.0]),
                                         2.0), getattr(jnls, name)())
    tc = tnls.init(tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0),
                   getattr(tnls, name)())
    jc.step(2)
    tc.step(2)
    np.testing.assert_allclose(tc.u.numpy(), np.asarray(jc.u), rtol=1e-13)
    jsol, tsol = jc.solve(), tc.solve()
    assert tsol.success
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    _same_root(jsol, tsol)


def test_iterator_polyalg_winner_retention():
    """A warm polyalgorithm cache keeps its winning rung across
    reinit / solve and probes the ladder again every 8th solve."""
    jc = jnls.init(jnls.NonlinearProblem(quadratic, jnp.array([1.0]), 2.0),
                   jnls.FastShortcutNonlinearPolyalg())
    tc = tnls.init(tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0),
                   tnls.FastShortcutNonlinearPolyalg())
    troots = []
    for pval in [1.0, 2.0, 3.0, 4.0, 5.0]:
        jc.reinit(p=jnp.asarray(pval))
        tc.reinit(p=_t(pval))
        jsol, tsol = jc.solve(), tc.solve()
        assert tsol.success
        _same_root(jsol, tsol)
        troots.append(float(tsol.u[0]))
        assert tc.best_subalgorithm == jc.best_subalgorithm is not None
    np.testing.assert_allclose(troots, np.sqrt([1.0, 2.0, 3.0, 4.0, 5.0]),
                               rtol=1e-9)
    with pytest.raises(NotImplementedError, match="polyalgorithm"):
        tc.step()
    with pytest.raises(NotImplementedError, match="polyalgorithm"):
        tc.solve(maxtime=1.0)


def test_polyalg_start_hint_wraps_around():
    """``run_polyalg(start_hint=k)`` runs the rungs from k first, the ones
    before it only when those fail — the JAX package's two passes."""
    def f_j(u, p):
        return jnp.array([jnp.exp(u[0]) - 2.0, u[1] ** 3 - u[0]])

    def f_t(u, p):
        return torch.stack([torch.exp(u[0]) - 2.0, u[1] ** 3 - u[0]])

    from nonlinearsolve_tpu.core.jacobian import JacobianSpec as JSpec
    from nonlinearsolve_tpu.core.descent import DescentCtx as JCtx
    from nonlinearsolve_tpu.core.termination import \
        default_termination_mode as jterm
    from nonlinearsolve_tpu.solvers.polyalg import run_polyalg as jrun
    from nonlinearsolve_tpu_torch.core.descent import DescentCtx as TCtx
    from nonlinearsolve_tpu_torch.core.termination import \
        default_termination_mode as tterm
    from nonlinearsolve_tpu_torch.solvers.polyalg import run_polyalg as trun
    jalg, talg = jnls.RobustMultiNewton(), tnls.RobustMultiNewton()
    for hint in (0, 2, 3):
        jcarry = jax.jit(lambda u0: jrun(
            jalg, JCtx(f_flat=lambda u: f_j(u, None), n_in=2, n_out=2,
                       is_least_squares=False), jterm(False), JSpec(), u0,
            jnp.asarray(1e-10), jnp.asarray(1e-10), jnp.int32(100),
            start_hint=jnp.int32(hint)))(jnp.array([1.0, 1.0]))
        with torch.no_grad():
            tcarry = trun(talg, TCtx(f_flat=lambda u: f_t(u, None), n_in=2,
                                     n_out=2), tterm(False), None,
                          _t([1.0, 1.0]), np.float64(1e-10),
                          np.float64(1e-10), 100, start_hint=hint)
        assert tcarry.winner == int(jcarry.winner) >= hint
        assert tcarry.rungs[0][0] == hint
        assert int(tcarry.retcode) == int(jcarry.retcode)
        np.testing.assert_allclose(tcarry.u.numpy(), np.asarray(jcarry.u),
                                   rtol=1e-12)


@pytest.mark.parametrize("name", ["DFSane", "AndersonAcceleration"])
def test_iterator_dfsane_and_anderson(name):
    def alg(m):
        return (m.DFSane() if name == "DFSane"
                else m.AndersonAcceleration(beta=-0.5))

    jc = jnls.init(jnls.NonlinearProblem(quadratic, jnp.array([1.0, 1.0]),
                                         2.0), alg(jnls))
    tc = tnls.init(tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0),
                   alg(tnls))
    jc.step(2)
    tc.step(2)
    assert tc.nsteps == 2
    np.testing.assert_allclose(tc.u.numpy(), np.asarray(jc.u), rtol=1e-13)
    jsol, tsol = jc.solve(), tc.solve()
    assert tsol.success
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    _same_root(jsol, tsol)
    # warm restart (integrator-style reuse)
    jc.reinit(p=jnp.asarray(9.0))
    tc.reinit(p=_t(9.0))
    _same_root(jc.solve(), tc.solve())
    np.testing.assert_allclose(tc.u.numpy(), 3.0, rtol=1e-8)


def test_implicit_euler_consumes_iterator():
    """One cache reused across backward-Euler steps through reinit,
    warm-started from the previous step's solution."""
    dt = 0.01

    def jres(u, p):
        u_prev, t_next = p
        return u - u_prev + dt * 50.0 * (u - jnp.cos(t_next))

    def tres(u, p):
        u_prev, t_next = p
        return u - u_prev + dt * 50.0 * (u - torch.cos(t_next))

    ju, tu = jnp.array([1.0]), _t([1.0])
    jc = jnls.init(jnls.NonlinearProblem(jres, ju, (ju, jnp.array(0.0))),
                   jnls.NewtonRaphson())
    tc = tnls.init(tnls.NonlinearProblem(tres, tu, (tu, _t(0.0))),
                   tnls.NewtonRaphson())
    ts = np.arange(1, 51) * dt
    jsteps = tsteps = 0
    for t in ts:
        jc.reinit(u0=ju, p=(ju, jnp.array(t)))
        tc.reinit(u0=tu, p=(tu, _t(t)))
        jsol, tsol = jc.solve(), tc.solve()
        assert tsol.success
        ju, tu = jsol.u, tsol.u
        jsteps += jc.nsteps
        tsteps += tc.nsteps
    assert tsteps == jsteps
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=1e-13)
    assert abs(float(tu[0]) - np.cos(ts[-1])) < 2e-2
    assert tsteps / len(ts) < 4


def test_checkpoint_resume_iterator(tmp_path):
    """Stop mid-iteration, save the carry, restore it into a fresh cache
    and finish: the same trajectory (the JAX test's orbax checkpoint)."""
    prob = tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0)
    cache = tnls.init(prob, tnls.NewtonRaphson())
    cache.step(2)
    u_mid = cache.u.clone()
    torch.save(cache.carry, tmp_path / "carry.pt")
    cache2 = tnls.init(prob, tnls.NewtonRaphson())
    cache2.carry = torch.load(tmp_path / "carry.pt", weights_only=False)
    assert torch.equal(cache2.u, u_mid)
    sol, ref = cache2.solve(), cache.solve()
    assert sol.success and sol.stats.nsteps >= 2
    assert torch.equal(sol.u, ref.u) and sol.stats == ref.stats


def test_homotopy_cache_waits_for_a30():
    """``init`` of a ``HomotopyProblem`` (ROADMAP A.30, ported): a
    ``HomotopySolveCache`` whose ``solve`` is the front door's, with the
    JAX package's root and NLStats; ``reinit`` of the tolerances."""
    from nonlinearsolve_tpu_torch.core.cache import HomotopySolveCache

    def H(u, p, lam):
        return u ** 3 - u - lam * p

    jcache = jnls.init(jnls.HomotopyProblem(H, jnp.array([1.2]), 1.5),
                       jnls.HomotopySweep(inner=jnls.NewtonRaphson()))
    tcache = tnls.init(tnls.HomotopyProblem(H, _t([1.2]), 1.5),
                       tnls.HomotopySweep(inner=tnls.NewtonRaphson()))
    assert isinstance(tcache, HomotopySolveCache)
    for tol in (None, 1e-12):
        if tol is not None:
            jcache.reinit(abstol=tol)
            assert tcache.reinit(abstol=tol) is tcache
        jsol, tsol = jcache.solve(), tcache.solve()
        assert tsol.success and int(tsol.retcode) == int(jsol.retcode)
        assert tsol.stats.nf == int(jsol.stats.nf)
        assert tsol.stats.nsteps == int(jsol.stats.nsteps)
        _same_root(jsol, tsol)


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def _both(f_j, f_t, u0, p, name="NewtonRaphson", **kw):
    jsol = jnls.solve(jnls.NonlinearProblem(f_j, jnp.asarray(u0), p),
                      getattr(jnls, name)(), **kw)
    tsol = tnls.solve(tnls.NonlinearProblem(f_t, _t(u0), p),
                      getattr(tnls, name)(), **kw)
    return jsol, tsol


def _same_norms(got, ref):
    """Per-step norms within rel 1e-10, or within 1e-14 of the first one
    once they reach the rounding floor (the two packages' residuals round
    differently there)."""
    got, ref = got.numpy(), np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-14 * ref[0])


def test_store_trace():
    jsol, tsol = _both(quadratic, quadratic, [1.0, 1.0], 2.0,
                       store_trace=True)
    n = tsol.trace.n
    assert n == int(jsol.trace.n) == tsol.stats.nsteps
    _same_norms(tsol.trace.fnorm[:n], jsol.trace.fnorm[:n])
    _same_norms(tsol.trace.dunorm[:n], jsol.trace.dunorm[:n])
    assert np.all(np.diff(tsol.trace.fnorm[:n].numpy()) < 0)
    assert "‖f‖" in repr(tsol.trace)


@pytest.mark.parametrize("name", ["Broyden", "DFSane"])
def test_trace_other_engines(name):
    jsol, tsol = _both(quadratic, quadratic, [1.0, 1.0], 2.0, name,
                       store_trace=True)
    n = tsol.trace.n
    assert n == int(jsol.trace.n)
    _same_norms(tsol.trace.fnorm[:n], jsol.trace.fnorm[:n])


def test_trace_condition_level():
    jsol, tsol = _both(quadratic, quadratic, [1.0, 2.0], 2.0,
                       store_trace=True, trace_level="condition")
    n = tsol.trace.n
    assert tsol.trace.condJ is not None
    np.testing.assert_allclose(tsol.trace.condJ[:n].numpy(),
                               np.asarray(jsol.trace.condJ[:n]), rtol=1e-10)
    assert np.all(tsol.trace.condJ[:n].numpy() >= 1.0)


def test_trace_all_level_stores_iterates():
    _, tsol = _both(quadratic, quadratic, [1.0, 1.0], 2.0,
                    store_trace=True, trace_level=tnls.TraceAll())
    n = tsol.trace.n
    np.testing.assert_allclose(tsol.trace.u_history[n - 1].numpy(),
                               np.sqrt(2.0), rtol=1e-6)


def test_show_trace_prints_each_step(capfd):
    jnls.solve(jnls.NonlinearProblem(quadratic, jnp.array([1.0, 1.0]), 2.0),
               jnls.NewtonRaphson(), show_trace=True)
    jax.effects_barrier()
    jout = capfd.readouterr().out
    tsol = tnls.solve(tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0),
                      tnls.NewtonRaphson(), show_trace=True)
    tout = capfd.readouterr().out
    assert tsol.trace is None
    assert tout.count("iter ") == jout.count("iter ") == tsol.stats.nsteps
    assert tout.splitlines()[0].split(":")[0] == \
        jout.splitlines()[0].split(":")[0] == "iter 1"


# ---------------------------------------------------------------------------
# messages
# ---------------------------------------------------------------------------

def _lines(text, tag):
    return [ln for ln in text.splitlines() if f"[nonlinearsolve_tpu:{tag}]"
            in ln]


def test_verbose_forcing_emission(capfd):
    def alg(m):
        from importlib import import_module
        fo = import_module(m.__name__ + ".solvers.first_order")
        return m.NewtonRaphson(linsolve=m.LinearSolver(method="gmres"),
                               forcing=fo.EisenstatWalkerForcing())

    tprob = tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0)
    tnls.solve(tprob, alg(tnls))
    assert "forcing eta" not in capfd.readouterr().out
    jnls.solve(jnls.NonlinearProblem(quadratic, jnp.array([1.0, 1.0]), 2.0),
               alg(jnls), verbose="all")
    jax.effects_barrier()
    jout = capfd.readouterr().out
    tsol = tnls.solve(tprob, alg(tnls), verbose="all")
    tout = capfd.readouterr().out
    assert len(_lines(tout, "forcing")) == len(_lines(jout, "forcing")) == \
        tsol.stats.nsteps
    assert "Eisenstat-Walker forcing eta = 0.5" in tout
    assert len(_lines(tout, "termination_condition")) == 1
    tnls.solve(tprob, alg(tnls))
    assert "forcing eta" not in capfd.readouterr().out


def test_verbose_non_enclosing_interval(capfd):
    jnls.solve(jnls.IntervalNonlinearProblem(lambda u, p: u * u + 1.0,
                                             (0.0, 1.0)), jnls.Bisection(),
               verbose="all")
    jerr = capfd.readouterr().err
    sol = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, p: u * u + 1.0, (_t(0.0), _t(1.0))), tnls.Bisection(),
        verbose="all")
    assert sol.retcode == tnls.ReturnCode.InitialFailure
    terr = capfd.readouterr().err
    assert _lines(terr, "non_enclosing_interval") == \
        _lines(jerr, "non_enclosing_interval") != []
    # a batch says it for each interval that encloses no sign change
    tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, p: u * u - p, (_t([0.0, 0.0]), _t([1.0, 2.0])),
        _t([4.0, 2.0])), tnls.Bisection(), verbose=True)
    assert len(_lines(capfd.readouterr().err, "non_enclosing_interval")) == 1


def test_verbosity_toggles_equal_jax():
    for T, J in ((tvrb.NonlinearVerbosity, jvrb.NonlinearVerbosity),):
        for preset in ("none", "minimal", "standard", "detailed", "all"):
            for cls in tvrb._CLASSES:
                assert T(preset).enabled(cls) == J(preset).enabled(cls)
                assert T(preset, **{cls: True}).enabled(cls)
                assert not T(preset, **{cls: False}).enabled(cls)
    assert tvrb._CLASSES == jvrb._CLASSES
    assert tvrb._LINEAR_CLASSES == jvrb._LINEAR_CLASSES
    v = tnls.NonlinearVerbosity("standard")
    assert v.enabled("non_enclosing_interval") and not v.enabled("forcing")
    with pytest.raises(ValueError):
        tnls.NonlinearVerbosity("bogus")
    with pytest.raises(ValueError):
        tvrb.LinearVerbosity("none", bogus=True)


def test_verbosity_group_control():
    v = tnls.NonlinearVerbosity("none", numerical=True)
    assert v.enabled("forcing") and v.enabled("threshold_state")
    assert not v.enabled("termination_condition")
    v2 = tnls.NonlinearVerbosity("all", error_control=False,
                                 termination_condition=True)
    assert v2.enabled("termination_condition")
    assert not v2.enabled("non_enclosing_interval")
    assert v2.enabled("forcing")
    for preset in ("minimal", "standard", "all"):
        for lc in tvrb._LINEAR_CLASSES:
            assert tnls.NonlinearVerbosity(preset).linear.enabled(lc) == \
                jvrb.NonlinearVerbosity(preset).linear.enabled(lc)


def test_verbosity_nested_linear(capfd):
    """The nested linear sub-specifier reaches the Krylov route: a starved
    GMRES says krylov_unconverged in both packages."""
    lv = tvrb.LinearVerbosity("none", krylov_unconverged=True)
    v = tnls.NonlinearVerbosity("none", linear_verbosity=lv)
    assert v.linear.enabled("krylov_unconverged")
    assert not v.linear.enabled("krylov_breakdown")

    def skewed_j(u, p):
        return jnp.array([4.0 * u[0] + u[1] ** 2 - p,
                          u[0] ** 3 + 0.5 * u[1] - p])

    def skewed_t(u, p):
        return torch.stack([4.0 * u[0] + u[1] ** 2 - p,
                            u[0] ** 3 + 0.5 * u[1] - p])

    def alg(m):
        return m.NewtonRaphson(linsolve=m.LinearSolver(
            method="gmres", restart=1, krylov_maxiter=1))

    jv = jvrb.NonlinearVerbosity(
        "none", linear_verbosity=jvrb.LinearVerbosity(
            "none", krylov_unconverged=True))
    jnls.solve(jnls.NonlinearProblem(skewed_j, jnp.array([1.0, 2.0]), 2.0),
               alg(jnls), verbose=jv, maxiters=3)
    jax.effects_barrier()
    jout = capfd.readouterr().out
    tnls.solve(tnls.NonlinearProblem(skewed_t, _t([1.0, 2.0]), 2.0),
               alg(tnls), verbose=v, maxiters=3)
    tout = capfd.readouterr().out
    tag = "linear:krylov_unconverged"
    assert len(_lines(tout, tag)) == len(_lines(jout, tag)) > 0


def test_precond_unavailable_message(capfd):
    """``precond="device_lu"`` on an operator that is not CSR proceeds
    unpreconditioned and says so (the linear precond_unavailable class)."""
    def alg(m):
        return m.NewtonRaphson(
            linsolve=m.LinearSolver(method="gmres", precond="device_lu"),
            autodiff=m.JacobianPolicy(mode="forward"))

    jsol = jnls.solve(jnls.NonlinearProblem(quadratic, jnp.array([1.0, 1.0]),
                                            2.0), alg(jnls), verbose=True)
    jerr = capfd.readouterr().err
    tsol = tnls.solve(tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0),
                      alg(tnls), verbose=True)
    terr = capfd.readouterr().err
    tag = "linear:precond_unavailable"
    # the text names the operator's type: a tracer in the JAX package
    assert _lines(terr, tag) and _lines(terr, tag)[0].replace(
        "Tensor", "DynamicJaxprTracer") == _lines(jerr, tag)[0]
    assert "not CSR" in _lines(terr, tag)[0]
    _same_root(jsol, tsol)


def test_verbose_alias_u0_and_sensitivity(capfd):
    prob = tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0)
    tnls.solve(prob, tnls.NewtonRaphson(), alias_u0=True, verbose="all")
    err = capfd.readouterr().err
    assert _lines(err, "alias_u0_immutable")
    assert _lines(err, "sensitivity_vjp_choice")
    tnls.solve(prob, tnls.NewtonRaphson(), alias_u0=True)
    assert "alias_u0_immutable" not in capfd.readouterr().err
    tnls.solve(prob, tnls.NewtonRaphson(), verbose=True,
               postcondition=tnls.PostconditionSpecifier(
                   lambda u, up, p: u, space="transformed"))
    assert _lines(capfd.readouterr().err, "unsupported_postcondition")


# ---------------------------------------------------------------------------
# phase timers and time budgets
# ---------------------------------------------------------------------------

def test_time_phases():
    prob = tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0)
    sol = tnls.solve(prob, tnls.NewtonRaphson(), time_phases=True)
    assert sol.success
    t = sol.timer
    assert set(t) >= {"jacobian", "descent", "linesearch", "other", "total"}
    phase_sum = t["jacobian"] + t["descent"] + t["linesearch"] + t["other"]
    assert phase_sum == pytest.approx(t["total"], rel=1e-6)
    assert t["total"] > 0 and t["jacobian"] > 0 and t["descent"] > 0
    sol2 = tnls.solve(prob, tnls.TrustRegion(), time_phases=True)
    assert sol2.timer["linesearch"] > 0
    assert tnls.solve(prob, tnls.NewtonRaphson()).timer is None
    # timing changes no result
    ref = tnls.solve(prob, tnls.TrustRegion())
    assert torch.equal(sol2.u, ref.u) and sol2.stats == ref.stats


def test_solve_maxtime():
    prob = tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0)
    sol = tnls.solve(prob, tnls.NewtonRaphson(), maxtime=0.0,
                     maxiters=100000)
    assert sol.retcode == tnls.ReturnCode.MaxTime
    jsol = jnls.solve(jnls.NonlinearProblem(quadratic, jnp.array([1.0, 1.0]),
                                            2.0), jnls.NewtonRaphson(),
                      maxtime=30.0)
    sol = tnls.solve(prob, tnls.NewtonRaphson(), maxtime=30.0)
    assert sol.success
    assert sol.stats.nsteps == int(jsol.stats.nsteps)
    _same_root(jsol, sol)


def test_iterator_maxtime():
    prob = tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0)
    cache = tnls.init(prob, tnls.NewtonRaphson(), maxiters=100000)
    sol = cache.solve(maxtime=0.0)
    assert sol.retcode == tnls.ReturnCode.MaxTime
    cache.reinit()
    assert cache.solve(maxtime=30.0).success


def test_iterator_maxtime_chunking():
    """More than one 16-step chunk, and no MaxIters at a chunk boundary:
    the JAX package's step count and root."""
    def jc_(m, u0):
        return m.init(m.NonlinearProblem(lambda u, p: u ** 3, u0, 0.0),
                      m.NewtonRaphson(), maxiters=500, abstol=1e-13)

    jc, tc = jc_(jnls, jnp.array([5.0])), jc_(tnls, _t([5.0]))
    jsol, tsol = jc.solve(maxtime=60.0), tc.solve(maxtime=60.0)
    assert tsol.success, tsol.retcode
    assert tc.nsteps == jc.nsteps > 16
    _same_root(jsol, tsol)


@pytest.mark.parametrize("mode", ["safe_best", "safe"])
def test_iterator_maxtime_stop_and_resume(mode, monkeypatch):
    """A budget that stops a solve after its first 16-step chunk (a clock
    that passes the deadline there), then ``solve()`` on the same cache:
    the bounded dense Brusselator (N=8, 18 steps) under TrustRegion.  The
    stop finishes the carry on the safe-best iterate and the next solve
    resumes from it, as in the JAX package: with a safe-best mode that
    may take other steps (here the root is the same to 1e-10); with a
    mode that keeps no best iterate, the resumed solve is the
    uninterrupted one, NLStats and root bit for bit."""
    from nonlinearsolve_tpu_torch.core import cache as tcache
    from nonlinearsolve_tpu_torch.models import brusselator
    base = brusselator.make_problem(8, torch.float64, device="cpu")
    prob = tnls.NonlinearProblem(base.f, base.u0, base.p, lb=0.0)
    kw = {"abstol": 1e-10}
    if mode == "safe":
        kw["termination_condition"] = tnls.AbsNormSafeTerminationMode(
            norm="linf", max_stalled_steps=32)
    whole = tnls.solve(prob, tnls.TrustRegion(), **kw)
    assert whole.success and whole.stats.nsteps > tcache._STEP_CHUNK

    readings = iter([0.0, 0.0])

    class _Clock:
        @staticmethod
        def monotonic():
            return next(readings, 2.0)

    cache = tnls.init(prob, tnls.TrustRegion(), **kw)
    monkeypatch.setattr(tcache, "time", _Clock)
    stopped = cache.solve(maxtime=1.0)
    assert stopped.retcode == tnls.ReturnCode.MaxTime
    assert stopped.stats.nsteps == tcache._STEP_CHUNK
    resumed = cache.solve()
    assert resumed.success
    if mode == "safe":
        assert resumed.stats == whole.stats
        assert torch.equal(resumed.u, whole.u)
    else:
        assert (resumed.u - whole.u).abs().max() <= 1e-10


def test_ensemble_maxtime_refused():
    """As in the JAX package: a budget is checked on the host between
    chunks, which a batch does not have."""
    with pytest.raises(NotImplementedError, match="ensemble"):
        tnls.solve_ensemble(tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0),
                            tnls.NewtonRaphson(), u0s=torch.ones(
                                (3, 1), dtype=torch.float64), maxtime=1.0)


# ---------------------------------------------------------------------------
# the initialization hook and kwarg hygiene
# ---------------------------------------------------------------------------

class TestInitializationHook:

    @staticmethod
    def _main_j(u, p):
        return jnp.array([u[0] + u[1] - p, u[1] ** 2 - u[0]])

    @staticmethod
    def _main_t(u, p):
        return torch.stack([u[0] + u[1] - p, u[1] ** 2 - u[0]])

    def test_consistent_init_runs_first(self):
        jdata = jnls.InitializationData(
            initializeprob=jnls.NonlinearProblem(
                lambda z, q: z ** 2 - q, jnp.array([0.5]), 1.0),
            initializeprobmap=lambda sol: jnp.concatenate(
                [jnp.array([1.0]), sol.u]))
        tdata = tnls.InitializationData(
            initializeprob=tnls.NonlinearProblem(
                lambda z, q: z ** 2 - q, _t([0.5]), 1.0),
            initializeprobmap=lambda sol: torch.cat([_t([1.0]), sol.u]))
        jsol = jnls.solve(jnls.NonlinearProblem(
            jnls.NonlinearFunction(f=self._main_j,
                                   initialization_data=jdata),
            jnp.array([9.0, 9.0]), 2.0), jnls.NewtonRaphson())
        tsol = tnls.solve(tnls.NonlinearProblem(
            tnls.NonlinearFunction(f=self._main_t,
                                   initialization_data=tdata),
            _t([9.0, 9.0]), 2.0), tnls.NewtonRaphson())
        assert tsol.success
        assert tsol.stats.nsteps == int(jsol.stats.nsteps)
        _same_root(jsol, tsol)
        np.testing.assert_allclose(tsol.u.numpy(), [1.0, 1.0], atol=1e-9)

    def test_failed_init_aborts_with_initial_failure(self):
        bad = tnls.NonlinearProblem(lambda z, q: z ** 2 + 1.0, _t([0.5]),
                                    None)
        fn = tnls.NonlinearFunction(
            f=self._main_t,
            initialization_data=tnls.InitializationData(initializeprob=bad))
        sol = tnls.solve(tnls.NonlinearProblem(fn, _t([9.0, 9.0]), 2.0),
                         tnls.NewtonRaphson())
        assert sol.retcode == tnls.ReturnCode.InitialFailure
        assert sol.original is not None
        with pytest.raises(RuntimeError, match="initialization"):
            tnls.init(tnls.NonlinearProblem(fn, _t([9.0, 9.0]), 2.0))

    def test_pmap_updates_parameters(self):
        idata = tnls.InitializationData(
            initializeprob=tnls.NonlinearProblem(lambda z, q: z ** 2 - q,
                                                 _t([0.5]), 1.0),
            initializeprobpmap=lambda sol, p: float(sol.u[0]) + 1.0)
        fn = tnls.NonlinearFunction(f=lambda u, p: u - p,
                                    initialization_data=idata)
        sol = tnls.solve(tnls.NonlinearProblem(fn, _t([0.0]), 99.0),
                         tnls.NewtonRaphson())
        np.testing.assert_allclose(float(sol.u[0]), 2.0, atol=1e-10)


def test_solve_rejects_unknown_kwargs():
    prob = tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0)
    with pytest.raises(TypeError, match="abstol"):
        tnls.solve(prob, tnls.NewtonRaphson(), abstoll=1e-8)
    with pytest.raises(TypeError, match="unrecognized"):
        tnls.solve(prob, maxiter=10)
    bad_prob = tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0,
                                     relto=1e-3)
    with pytest.raises(TypeError, match="relto"):
        tnls.solve(bad_prob)


def test_solve_nonlinear_kwarg_hygiene():
    from nonlinearsolve_tpu_torch.core.solve import solve_nonlinear
    prob = tnls.NonlinearProblem(lambda u, p: u ** 2 - 2.0, _t([1.0]))
    with pytest.raises(TypeError, match="abstol"):
        solve_nonlinear(prob, tnls.NewtonRaphson(), abstoll=1e-6)
    with pytest.raises(TypeError, match="front door"):
        solve_nonlinear(prob, tnls.NewtonRaphson(), maxtime=1.0)


def test_options_on_the_lockstep_batch_solve_lone():
    """A simple-tier batch with options the lockstep loop does not take
    (bounds, a left preconditioner) solves trajectory by trajectory."""
    prob = tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0, lb=0.0)
    sol = tnls.solve_ensemble(prob, tnls.SimpleNewtonRaphson(),
                              ps=_t([1.0, 4.0, 9.0]),
                              precondition=lambda fu, u, p: 3.0 * fu)
    np.testing.assert_allclose(sol.u[:, 0].numpy(), [1.0, 2.0, 3.0],
                               rtol=1e-10)
    assert sol.retcode.tolist() == [int(tnls.ReturnCode.Success)] * 3


def test_stdout_of_quiet_solves_is_empty(capfd):
    tnls.solve(tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0),
               tnls.NewtonRaphson(), store_trace=True, time_phases=True)
    out = capfd.readouterr()
    assert out.out == "" and out.err == ""

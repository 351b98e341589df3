"""The JAX package's own tests of the quasi-Newton, spectral and Anderson
engines and the polyalgorithms, run in both packages on the same inputs
(f64 on the CPU unless the JAX test is f32):

- ``tests/test_qn_trustregion.py`` (its 7 tests: Broyden and Klement
  with a trust region);
- ``tests/test_core_solvers.py``'s ``test_default_polyalgorithm``,
  ``test_newton_fails_polyalg_rescues``, ``test_limited_memory_broyden``,
  ``test_anderson_acceleration`` and the α-scaled Broyden line-search
  regression (``test_broyden_linesearch_secant_uses_actual_step``);
- ``tests/test_linesearch.py``'s Broyden / Klement × the Wolfe searches.

Each holds the JAX test's own assertions on the port, and the port to the
JAX package's retcode, nsteps, nf and njacs with roots within rel-inf
1e-10 (``same``), except where a check says otherwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls

torch.set_num_threads(1)

ROOT_RTOL = 1e-10


def _t(x, dtype=torch.float64):
    return torch.tensor(np.asarray(x), dtype=dtype)


def same(jsol, tsol, root_rtol=ROOT_RTOL, stats=True, retcode=True):
    """The port's solution against the JAX package's."""
    if retcode:
        assert int(tsol.retcode) == int(jsol.retcode)
    if stats:
        assert {k: getattr(tsol.stats, k) for k in ("nsteps", "nf", "njacs")} \
            == {k: int(getattr(jsol.stats, k))
                for k in ("nsteps", "nf", "njacs")}
    ju, tu = np.asarray(jsol.u), tsol.u.numpy()
    rel = np.abs(tu - ju).max() / max(np.abs(ju).max(), 1.0)
    assert rel <= root_rtol, rel


def both(f_jax, f_torch, u0, p=None, alg=None, dtype=torch.float64, **kw):
    """Solve in both packages; ``alg(m)`` builds the algorithm (None: the
    default polyalgorithm); ``p`` a number or a numpy array."""
    jp = jnp.asarray(p) if isinstance(p, np.ndarray) else p
    tp = _t(p, dtype) if isinstance(p, np.ndarray) else p
    jprob = jnls.NonlinearProblem(f_jax, jnp.asarray(u0), jp)
    tprob = tnls.NonlinearProblem(f_torch, _t(u0, dtype), tp)
    if alg is None:
        return jnls.solve(jprob, **kw), tnls.solve(tprob, **kw)
    return jnls.solve(jprob, alg(jnls), **kw), tnls.solve(tprob, alg(tnls),
                                                          **kw)


def quadratic(u, p):
    return u ** 2 - p


# --- tests/test_qn_trustregion.py ------------------------------------------

def rosenbrock_like_j(u, p):
    return jnp.array([10.0 * (u[1] - u[0] ** 2), 1.0 - u[0]])


def rosenbrock_like_t(u, p):
    return torch.stack([10.0 * (u[1] - u[0] ** 2), 1.0 - u[0]])


def _tr_algs():
    def broyden_tr(m):
        return m.QuasiNewtonAlgorithm(
            update_rule="good_broyden", structure="full",
            trustregion=m.GenericTrustRegionScheme(), name="BroydenTR")

    def broyden_tr_true(m):
        return m.QuasiNewtonAlgorithm(
            update_rule="good_broyden", structure="full",
            init_jacobian="true_jacobian",
            trustregion=m.GenericTrustRegionScheme(), name="BroydenTR-trueJ")

    def klement_tr(m):
        rule = (jqn if m is jnls else tqn).NoChangeInStateReset(
            check_dfu=False)
        return m.QuasiNewtonAlgorithm(
            update_rule="klement", structure="full",
            init_jacobian="true_jacobian", reinit_rule=rule,
            trustregion=m.GenericTrustRegionScheme(), name="KlementTR")

    return {"BroydenTR": broyden_tr, "BroydenTR-trueJ": broyden_tr_true,
            "KlementTR": klement_tr}


from nonlinearsolve_tpu.solvers import quasi_newton as jqn  # noqa: E402
from nonlinearsolve_tpu_torch.solvers import quasi_newton as tqn  # noqa

TR_ALGS = _tr_algs()


@pytest.mark.parametrize("name", list(TR_ALGS))
def test_qn_tr_quadratic(name):
    jsol, tsol = both(quadratic, quadratic, [1.0, 1.0], 2.0, TR_ALGS[name])
    assert tsol.success
    np.testing.assert_allclose(tsol.u.numpy(), np.sqrt(2.0), rtol=1e-8)
    same(jsol, tsol)


# KlementTR on the Rosenbrock valley: the two runs agree to 1e-13 through
# step 30 and part at a trust-region decision near step 35 (the ratio at
# its threshold); both reach the root after about 250 steps, where the
# JAX package's last iterate lands under abstol 3e-13 (Success, 250
# steps) and the port's at |f| 4.8e-13 (Stalled, 244 steps).  The port is
# held to the root and to the f64 floor instead of to the retcode.
FLOOR_KNIFE_EDGE = {"KlementTR"}


@pytest.mark.parametrize("name", list(TR_ALGS))
def test_qn_tr_rosenbrock(name):
    jsol, tsol = both(rosenbrock_like_j, rosenbrock_like_t, [-1.2, 1.0],
                      None, TR_ALGS[name], maxiters=1000)
    assert jsol.success
    np.testing.assert_allclose(tsol.u.numpy(), [1.0, 1.0], atol=1e-7)
    if name in FLOOR_KNIFE_EDGE:
        assert tsol.success or tsol.retcode == tnls.ReturnCode.Stalled
        assert float(tsol.resid.abs().max()) < 1e-12
        same(jsol, tsol, stats=False, retcode=False)
        return
    assert tsol.success
    same(jsol, tsol)


@pytest.mark.parametrize("scheme", ["simple", "nlsolve", "fan"])
def test_qn_tr_radius_schemes(scheme):
    def alg(m):
        return m.QuasiNewtonAlgorithm(
            update_rule="klement", structure="full",
            init_jacobian="true_jacobian",
            trustregion=m.GenericTrustRegionScheme(method=scheme))

    jsol, tsol = both(lambda u, p: jnp.tanh(u) - 0.5 * u - 0.1,
                      lambda u, p: torch.tanh(u) - 0.5 * u - 0.1,
                      [2.0, 2.0], None, alg, maxiters=300)
    assert tsol.success
    assert float(tsol.resid.abs().max()) < 1e-8
    same(jsol, tsol)


def test_qn_tr_reject_streak_resets_jacobian():
    """Three rejections in a row reinitialize J: fewer steps and fewer
    Jacobians than without the reset, in both packages alike."""
    def alg(rejects):
        def make(m):
            rule = (jqn if m is jnls else tqn).NoChangeInStateReset(
                check_dfu=False)
            return m.QuasiNewtonAlgorithm(
                update_rule="klement", structure="full",
                init_jacobian="true_jacobian", reinit_rule=rule,
                trustregion=m.GenericTrustRegionScheme(),
                tr_reset_rejects=rejects)
        return make

    jfast, fast = both(rosenbrock_like_j, rosenbrock_like_t, [-1.2, 1.0],
                       None, alg(3), maxiters=2000)
    jslow, slow = both(rosenbrock_like_j, rosenbrock_like_t, [-1.2, 1.0],
                       None, alg(10 ** 6), maxiters=2000)
    assert jfast.success
    assert fast.stats.nsteps < 350
    assert fast.stats.nsteps < slow.stats.nsteps // 2
    assert fast.stats.njacs < slow.stats.njacs
    # the fast run is test_qn_tr_rosenbrock[KlementTR]'s (FLOOR_KNIFE_EDGE)
    assert float(fast.resid.abs().max()) < 1e-12
    same(jfast, fast, stats=False, retcode=False)
    # the slow run shrinks its radius to 1e-13 in rejection streaks, where
    # NoChange resets follow: the two runs agree to 1e-9 through step 20,
    # then one expands its radius a step before the other, and the JAX run
    # ends Stalled at the root (715 steps, 42 Jacobians), the port's with
    # its 100 resets spent (ConvergenceFailure, 957 steps, 101 Jacobians).
    # Only the JAX test's comparisons above hold it.
    assert int(jfast.stats.nsteps) < int(jslow.stats.nsteps) // 2


def test_qn_tr_rejection_keeps_iterate_monotone():
    """A rejected step keeps the iterate; the solve ends below where it
    started, in both packages' stored traces (rejected steps hold ‖f‖
    flat)."""
    def alg(m):
        return m.QuasiNewtonAlgorithm(
            update_rule="good_broyden", structure="full",
            trustregion=m.GenericTrustRegionScheme())

    def fj(u, p):
        return jnp.array([jnp.exp(u[0]) - 2.0, u[1] ** 3 - u[0]])

    def ft(u, p):
        return torch.stack([torch.exp(u[0]) - 2.0, u[1] ** 3 - u[0]])

    jsol, tsol = both(fj, ft, [3.0, 2.0], None, alg, maxiters=500,
                      store_trace=True)
    assert tsol.success
    f0 = float(ft(_t([3.0, 2.0]), None).norm())
    assert float(tsol.resid.norm()) < f0
    same(jsol, tsol)
    n = tsol.trace.n
    assert n == int(jsol.trace.n) == tsol.stats.nsteps
    fn = tsol.trace.fnorm[:n].numpy()
    assert fn[-1] < fn[0]
    np.testing.assert_allclose(fn, np.asarray(jsol.trace.fnorm[:n]),
                               rtol=1e-10, atol=1e-14 * fn[0])


def test_qn_tr_shrink_threshold_exceeded():
    """A problem with no real root and a shrink cap of 3 ends in
    ShrinkThresholdExceeded or Stalled, as in the JAX package."""
    def alg(m):
        return m.QuasiNewtonAlgorithm(
            update_rule="good_broyden", structure="full",
            trustregion=m.GenericTrustRegionScheme(), max_shrink_times=3)

    jsol, tsol = both(lambda u, p: u ** 2 + 1.0, lambda u, p: u ** 2 + 1.0,
                      [1.0], None, alg, maxiters=200)
    assert tsol.retcode in (tnls.ReturnCode.ShrinkThresholdExceeded,
                            tnls.ReturnCode.Stalled)
    assert not tsol.success
    same(jsol, tsol)


# --- tests/test_core_solvers.py ---------------------------------------------

def test_default_polyalgorithm():
    jsol, tsol = both(quadratic, quadratic, [1.0, 1.0], np.array(2.0))
    assert tsol.success
    np.testing.assert_allclose(tsol.u.numpy(), np.sqrt(2.0), rtol=1e-8)
    same(jsol, tsol)
    assert tsol.counters["winner"] == 0          # Broyden


def _newton_fails(mod):
    def f(u, p):
        return (0.010000000000000002
                + 10.000000000000002 / (1 + (0.21640425613334457
                                             + 216.40425613334457 / (1 + (0.21640425613334457
                                                                          + 216.40425613334457 / (1 + 0.0006250000000000001 * u ** 2)) ** 2)) ** 2)
                - 0.0011552453009332421 * u - p)
    return f


def test_newton_fails_polyalg_rescues():
    jsol, tsol = both(_newton_fails(jnp), _newton_fails(torch), [-1.0],
                      np.array(0.0), lambda m: m.RobustMultiNewton())
    assert tsol.success
    assert float(tsol.resid.abs().max()) < 1e-9
    same(jsol, tsol)


def test_limited_memory_broyden():
    jsol, tsol = both(quadratic, quadratic, [1.0, 1.0], np.array(2.0),
                      lambda m: m.LimitedMemoryBroyden())
    assert tsol.success
    np.testing.assert_allclose(tsol.u.numpy(), np.sqrt(2.0), rtol=1e-6)
    same(jsol, tsol)
    # n > threshold: the ring carries every step
    jsol, tsol = both(lambda u, p: u + 0.1 * jnp.tanh(u) - p,
                      lambda u, p: u + 0.1 * torch.tanh(u) - p,
                      np.zeros(40), 0.5 * np.ones(40),
                      lambda m: m.LimitedMemoryBroyden(threshold=10))
    assert tsol.success
    assert float(tsol.resid.abs().max()) < 1e-9
    same(jsol, tsol)


def test_anderson_acceleration():
    jsol, tsol = both(quadratic, quadratic, [1.0, 1.0], 2.0,
                      lambda m: m.AndersonAcceleration(beta=-0.5))
    assert tsol.success
    np.testing.assert_allclose(tsol.u.numpy(), np.sqrt(2.0), rtol=1e-8)
    same(jsol, tsol)
    # the fixed point u = cos(u): under 40 steps
    jsol, tsol = both(lambda u, p: jnp.cos(u) - u,
                      lambda u, p: torch.cos(u) - u, [0.0], None,
                      lambda m: m.AndersonAcceleration())
    assert tsol.success
    np.testing.assert_allclose(float(tsol.u[0]), 0.7390851332151607,
                               rtol=1e-8)
    assert tsol.stats.nsteps < 40
    same(jsol, tsol)
    # a 100-d near-singular smoothing map
    n = 100
    A = (np.eye(n) * 0.4 + np.diag(np.ones(n - 1) * 0.28, 1)
         + np.diag(np.ones(n - 1) * 0.28, -1))
    b = np.random.default_rng(0).standard_normal(n)
    jA, tA = jnp.asarray(A), _t(A)
    jsol, tsol = both(lambda u, p: jA @ u + 0.05 * jnp.tanh(u) + p - u,
                      lambda u, p: tA @ u + 0.05 * torch.tanh(u) + p - u,
                      np.zeros(n), b,
                      lambda m: m.AndersonAcceleration(m=8), abstol=1e-8,
                      maxiters=2000)
    assert int(tsol.retcode) == int(jsol.retcode)
    assert float(tsol.resid.abs().max()) <= \
        10 * float(jnp.max(jnp.abs(jsol.resid)))


@pytest.mark.parametrize("seed", [0, 1, 3])
def test_broyden_linesearch_secant_uses_actual_step(seed):
    """The α-scaled step feeds the secant update: f32, the affine 4×4
    system converges with LiFukushima in both packages."""
    rng = np.random.RandomState(seed)
    A = rng.rand(4, 4).astype(np.float32)
    u0 = rng.rand(4).astype(np.float32)
    b = rng.rand(4).astype(np.float32)
    jA, jb = jnp.asarray(A), jnp.asarray(b)
    tA, tb = _t(A, torch.float32), _t(b, torch.float32)
    jsol, tsol = both(lambda u, p: jA @ u + jb, lambda u, p: tA @ u + tb,
                      u0, None,
                      lambda m: m.Broyden(
                          linesearch=m.LiFukushimaLineSearch()),
                      dtype=torch.float32, abstol=1e-5, reltol=1e-5)
    # the JAX test's check, in both packages; at abstol 1e-5 in f32 the
    # runs end at the f32 floor of the residual, where the retcode (Success
    # or Stalled) and the count are rounding's, so they are not compared
    assert float(torch.linalg.norm(tA @ tsol.u + tb)) < 1e-4
    assert float(jnp.linalg.norm(jA @ jsol.u + jb)) < 1e-4


# --- tests/test_linesearch.py: Broyden / Klement × the Wolfe searches ----

def broyden_tridiagonal(mod):
    def f(u, p):
        z = mod.zeros_like(u[:1])
        left = mod.concatenate([z, u[:-1]]) if mod is jnp else \
            torch.cat([z, u[:-1]])
        right = mod.concatenate([u[1:], z]) if mod is jnp else \
            torch.cat([u[1:], z])
        return (3.0 - 2.0 * u) * u - left - 2.0 * right + 1.0
    return f


@pytest.mark.parametrize("ls", ["StrongWolfe", "HagerZhang", "MoreThuente",
                                "StaticLineSearch"])
@pytest.mark.parametrize("make", ["Broyden", "Klement"])
def test_quasi_newton_with_wolfe_searches(make, ls):
    jsol, tsol = both(broyden_tridiagonal(jnp), broyden_tridiagonal(torch),
                      -np.ones(8), None,
                      lambda m: getattr(m, make)(linesearch=getattr(m, ls)()),
                      maxiters=1000)
    if (make, ls) != ("Klement", "StaticLineSearch"):
        # the JAX test's assertions (it skips Klement with the static
        # search; here both packages run it and are compared)
        assert tsol.retcode == tnls.ReturnCode.Success
        assert float(tsol.resid.abs().max()) < 1e-9
    # Klement's diagonal model takes 87–109 steps here; the residuals round
    # differently in the two packages (see test_torch_23_qn.py), and the
    # counts part by up to 5 steps: Klement is held to the retcode and root
    same(jsol, tsol, stats=make != "Klement")

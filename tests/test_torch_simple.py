"""The simple tier against the JAX package, on the CPU (f64 unless said
otherwise): every engine on small problems, the JAX package's own
line-search cases (``tests/test_core_solvers.py``'s
``test_simple_tier_linesearch_paths``, f32), an analytic Jacobian, a
non-square SimpleGaussNewton, a 0-d ``u0`` and the nine termination modes.

Each solve must give the JAX package's retcode and ``NLStats`` and a root
within rel-inf 1e-12 (``ROOT_RTOL``; f32: 1e-5, ``ROOT_RTOL_F32``; the SVD
least squares of a non-square system: 1e-10, ``ROOT_RTOL_SVD``, as XLA's
SVD and LAPACK's round apart by about 2e-12 there).  Batches:
``test_torch_simple_batch.py``.

The residuals are written as XLA evaluates the JAX ones where that
decides a count: XLA contracts ``u * u - p`` and ``u0² + u1`` into one
fused multiply-add each, so the port's side is ``torch.addcmul`` there.

Named exception (``LINESEARCH_F32``): on the f32 line-search case the
port's SimpleBroyden takes 46 steps and 403 residuals against the JAX
package's 45 and 398; the JAX package itself gives exactly (46, 403) from
u0 with u0[0] one ulp up, and MaxIters after 1000 steps with u0[1] one ulp
up.  The case keeps the JAX test's residual bound and the retcode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu_torch import _backend

torch.set_num_threads(1)

F64 = torch.float64
ROOT_RTOL = 1e-12
ROOT_RTOL_F32 = 1e-5
ROOT_RTOL_SVD = 1e-10
STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")

ENGINES = {
    "SimpleNewtonRaphson": lambda m: m.SimpleNewtonRaphson(),
    "SimpleGaussNewton": lambda m: m.SimpleGaussNewton(),
    "SimpleBroyden": lambda m: m.SimpleBroyden(),
    "SimpleBroyden-alpha": lambda m: m.SimpleBroyden(alpha=2.0),
    "SimpleBroyden-linesearch": lambda m: m.SimpleBroyden(linesearch=True),
    "SimpleKlement": lambda m: m.SimpleKlement(),
    "SimpleDFSane": lambda m: m.SimpleDFSane(),
    "SimpleHalley": lambda m: m.SimpleHalley(),
    "SimpleTrustRegion": lambda m: m.SimpleTrustRegion(),
    "SimpleTrustRegion-NLsolve": lambda m: m.SimpleTrustRegion(
        nlsolve_update_rule=True),
    "SimpleTrustRegion-radius": lambda m: m.SimpleTrustRegion(
        initial_trust_radius=0.5, max_trust_radius=4.0),
    "SimpleLimitedMemoryBroyden": lambda m: m.SimpleLimitedMemoryBroyden(),
    "SimpleLimitedMemoryBroyden-ring": lambda m: m.SimpleLimitedMemoryBroyden(
        threshold=2),
    "SimpleLimitedMemoryBroyden-ring-ls": lambda m:
        m.SimpleLimitedMemoryBroyden(threshold=2, linesearch=True),
}


def _t(x, dtype=F64):
    return torch.tensor(x, dtype=dtype)


def _jquad(u, p):
    return u * u - p


def _tquad(u, p):
    return torch.addcmul(-p if isinstance(p, torch.Tensor)
                         else torch.full_like(u, -p), u, u)


def _jtrig(u, p):
    """A coupled 3-unknown system: each engine takes several steps."""
    return jnp.stack([u[0] ** 2 + u[1] - p, jnp.sin(u[1]) + u[2] - 0.5,
                      u[0] * u[2] + u[2] - 1.0])


def _ttrig(u, p):
    return torch.stack([torch.addcmul(u[1], u[0], u[0]) - p,
                        torch.sin(u[1]) + u[2] - 0.5,
                        torch.addcmul(u[2], u[0], u[2]) - 1.0])


def _jnan(u, p):
    """No finite residual at the start: sqrt of a negative number."""
    return jnp.sqrt(u - 3.0) + 1.0


def _tnan(u, p):
    return torch.sqrt(u - 3.0) + 1.0


def _bits_equal(a, b):
    """Equal values, NaN where the other has NaN."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def _same(jsol, tsol, rtol=ROOT_RTOL, counts=True):
    assert int(tsol.retcode) == int(jsol.retcode)
    if counts:
        assert {k: getattr(tsol.stats, k) for k in STATS} == \
            {k: int(getattr(jsol.stats, k)) for k in STATS}
    ju, tu = np.asarray(jsol.u), tsol.u.numpy()
    assert tu.shape == ju.shape
    if bool(jnls.ReturnCode.successful(int(jsol.retcode))):
        rel = np.abs(tu - ju).max() / max(np.abs(ju).max(), 1.0)
        assert rel <= rtol, rel


@pytest.mark.parametrize("name", sorted(ENGINES))
@pytest.mark.parametrize("problem", ["quadratic", "coupled"])
def test_engine_against_jax(name, problem):
    make = ENGINES[name]
    if problem == "quadratic":
        jprob = jnls.NonlinearProblem(_jquad, jnp.array([1.0, 1.5, 0.7]),
                                      2.0)
        tprob = tnls.NonlinearProblem(_tquad, _t([1.0, 1.5, 0.7]), 2.0)
    else:
        jprob = jnls.NonlinearProblem(_jtrig, jnp.array([1.0, 0.2, 0.3]),
                                      1.5)
        tprob = tnls.NonlinearProblem(_ttrig, _t([1.0, 0.2, 0.3]), 1.5)
    jsol = jnls.solve(jprob, make(jnls), maxiters=200)
    tsol = tnls.solve(tprob, make(tnls), maxiters=200)
    _same(jsol, tsol)
    # one flag read a step, one more to see the loop end, one for the
    # retcode and counts (the line searches add one a trial)
    if "linesearch" not in name and "-ls" not in name and \
            "DFSane" not in name:
        assert tsol.counters["host_syncs"] == tsol.stats.nsteps + 2


def test_linesearch_paths_f32():
    """tests/test_core_solvers.py::test_simple_tier_linesearch_paths: the
    Li–Fukushima line search in SimpleBroyden and SimpleLimitedMemoryBroyden
    on A u + b, f32."""
    rng = np.random.RandomState(1)
    A = rng.rand(4, 4).astype(np.float32)
    u0 = rng.rand(4).astype(np.float32)
    b = rng.rand(4).astype(np.float32)
    jprob = jnls.NonlinearProblem(
        lambda u, p: jnp.asarray(A) @ u + jnp.asarray(b), jnp.asarray(u0))
    tA, tb = torch.tensor(A), torch.tensor(b)
    tprob = tnls.NonlinearProblem(lambda u, p: tA @ u + tb, torch.tensor(u0))
    for name in ("SimpleBroyden", "SimpleLimitedMemoryBroyden"):
        jsol = jnls.solve(jprob, getattr(jnls, name)(linesearch=True),
                          abstol=1e-5, reltol=1e-5, maxiters=1000)
        tsol = tnls.solve(tprob, getattr(tnls, name)(linesearch=True),
                          abstol=1e-5, reltol=1e-5, maxiters=1000)
        assert float(torch.linalg.norm(tA @ tsol.u + tb)) < 1e-4
        assert tsol.u.dtype == torch.float32
        assert (int(jsol.stats.nsteps), int(jsol.stats.nf)) == \
            LINESEARCH_F32["jax"]
        assert (tsol.stats.nsteps, tsol.stats.nf) == LINESEARCH_F32["port"]
        _same(jsol, tsol, ROOT_RTOL_F32, counts=False)
    # the JAX package from u0[0] one ulp up lands on the port's counts
    x = u0.copy()
    x[0] = np.nextafter(x[0], np.float32(np.inf))
    moved = jnls.solve(jnls.NonlinearProblem(jprob.f, jnp.asarray(x)),
                       jnls.SimpleBroyden(linesearch=True), abstol=1e-5,
                       reltol=1e-5, maxiters=1000)
    assert (int(moved.stats.nsteps), int(moved.stats.nf)) == \
        LINESEARCH_F32["port"]


LINESEARCH_F32 = {"jax": (45, 398), "port": (46, 403)}


@pytest.mark.parametrize("name", ["SimpleNewtonRaphson", "SimpleTrustRegion"])
def test_analytic_jacobian(name):
    """``NonlinearFunction(jac=...)``: Newton and the trust region use it
    (Halley always differentiates)."""
    calls = []

    def tjac(u, p):
        calls.append(1)
        return torch.diag(2.0 * u)

    jprob = jnls.NonlinearProblem(jnls.NonlinearFunction(
        _jquad, jac=lambda u, p: jnp.diag(2.0 * u)), jnp.array([1.0, 3.0]),
        2.0)
    tprob = tnls.NonlinearProblem(tnls.NonlinearFunction(_tquad, jac=tjac),
                                  _t([1.0, 3.0]), 2.0)
    jsol = jnls.solve(jprob, getattr(jnls, name)())
    tsol = tnls.solve(tprob, getattr(tnls, name)())
    _same(jsol, tsol)
    assert calls, "the analytic Jacobian was not called"


def test_non_square_gauss_newton():
    """SimpleGaussNewton on a least-squares problem (3 residuals, 2
    unknowns): the SVD least squares of ``jnp.linalg.lstsq``; the simple
    callee's default termination for least squares (AbsNorm, L2)."""
    def jf(u, p):
        return jnp.stack([u[0] - 1.0, u[1] - 2.0, u[0] * u[1] - 2.1])

    def tf(u, p):
        return torch.stack([u[0] - 1.0, u[1] - 2.0, u[0] * u[1] - 2.1])

    jprob = jnls.NonlinearLeastSquaresProblem(jf, jnp.array([0.5, 0.5]))
    tprob = tnls.NonlinearLeastSquaresProblem(tf, _t([0.5, 0.5]))
    # the JAX package's default here (AbsNorm, L2) adds fu + u before it
    # looks at the mode, which a non-square system cannot do (ROADMAP C)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jnls.solve(jprob, jnls.SimpleGaussNewton())
    for mode, tol in (("AbsTerminationMode", 1e-3),
                      ("AbsNormSafeTerminationMode", None)):
        jsol = jnls.solve(jprob, jnls.SimpleGaussNewton(), abstol=tol,
                          termination_condition=getattr(jnls, mode)())
        tsol = tnls.solve(tprob, tnls.SimpleGaussNewton(), abstol=tol,
                          termination_condition=getattr(tnls, mode)())
        _same(jsol, tsol, ROOT_RTOL_SVD)
        assert tsol.resid.shape == (3,)
    # the port's default reads only ‖fu‖: the AbsNormSafe run's counts
    sol = tnls.solve(tprob, tnls.SimpleGaussNewton())
    safe = tnls.solve(tprob, tnls.SimpleGaussNewton(),
                      termination_condition=tnls.AbsNormSafeTerminationMode())
    assert (int(sol.retcode), sol.stats) == (int(safe.retcode), safe.stats)


@pytest.mark.parametrize("name", ["SimpleNewtonRaphson", "SimpleBroyden",
                                  "SimpleHalley", "SimpleDFSane"])
def test_zero_dim_u0(name):
    """A 0-d state on the simple tier: flattened, solved, given back 0-d
    (the other engines take it on the flat path since ROADMAP A.33)."""
    jsol = jnls.solve(jnls.NonlinearProblem(_jquad, jnp.asarray(1.0), 2.0),
                      getattr(jnls, name)())
    tsol = tnls.solve(tnls.NonlinearProblem(_tquad, _t(1.0), 2.0),
                      getattr(tnls, name)())
    assert tsol.u.shape == () and tsol.resid.shape == ()
    _same(jsol, tsol)
    np.testing.assert_allclose(float(tsol.u), np.sqrt(2.0), rtol=1e-12)


MODES = ["RelTerminationMode", "AbsTerminationMode", "NormTerminationMode",
         "RelNormTerminationMode", "AbsNormTerminationMode",
         "RelNormSafeTerminationMode", "AbsNormSafeTerminationMode",
         "RelNormSafeBestTerminationMode", "AbsNormSafeBestTerminationMode"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["SimpleNewtonRaphson", "SimpleBroyden"])
def test_termination_modes(mode, name):
    """The nine modes on a converging problem and on one whose residual is
    NaN from the start (the safe modes stop it as Unstable)."""
    kw = {"max_stalled_steps": 5} if "Safe" in mode else {}
    jcfg = getattr(jnls, mode)(**kw)
    tcfg = getattr(tnls, mode)(**kw)
    cases = [(jnls.NonlinearProblem(_jtrig, jnp.array([1.0, 0.2, 0.3]), 1.5),
              tnls.NonlinearProblem(_ttrig, _t([1.0, 0.2, 0.3]), 1.5)),
             (jnls.NonlinearProblem(_jnan, jnp.array([1.0, 2.0])),
              tnls.NonlinearProblem(_tnan, _t([1.0, 2.0])))]
    for jprob, tprob in cases:
        jsol = jnls.solve(jprob, getattr(jnls, name)(),
                          termination_condition=jcfg, maxiters=200)
        tsol = tnls.solve(tprob, getattr(tnls, name)(),
                          termination_condition=tcfg, maxiters=200)
        _same(jsol, tsol)


def test_maxiters_zero_and_host_reads():
    prob = tnls.NonlinearProblem(_tquad, _t([1.0, 1.5]), 2.0)
    sol = tnls.solve(prob, tnls.SimpleNewtonRaphson(), maxiters=0)
    assert sol.retcode == tnls.ReturnCode.MaxIters
    assert sol.stats.nsteps == 0 and sol.stats.nf == 1
    _backend.reset_counters()
    sol = tnls.solve(prob, tnls.SimpleNewtonRaphson())
    assert _backend.HOST_SYNCS["n"] == sol.counters["host_syncs"] == \
        sol.stats.nsteps + 2


@pytest.mark.parametrize("mode,kw", [
    ("rel", {}), ("abs", {}), ("norm", {}), ("rel_norm", {}),
    ("abs_norm", {}), ("abs_norm_safe", {}),
    ("abs_norm_safe", {"protective_threshold": 1.0}),
    ("rel_norm_safe", {"max_stalled_steps": 3}),
    ("abs_norm_safe_best", {"max_stalled_steps": 3}),
    ("abs_norm_safe_best", {"patience_steps": 2}),
    ("rel_norm_safe_best", {"patience_steps": 3})])
@pytest.mark.parametrize("lsq", [False, True])
def test_batched_termination_equals_jax(mode, kw, lsq):
    """The batched check against the JAX package's check_termination, one
    row a residual sequence: improving, stalling, diverging, non-finite;
    each row's stop, retcode, step count and kept iterate at every
    check."""
    from nonlinearsolve_tpu.core import termination as jtrm
    from nonlinearsolve_tpu_torch.core import termination as ttrm
    jcfg = jtrm.TerminationCondition(mode=mode, norm="linf", **kw)
    tcfg = ttrm.TerminationCondition(mode=mode, norm="linf", **kw)
    rng = np.random.default_rng(5)
    rows, n, nchecks = 6, 4, 12
    scales = rng.choice([1.0, 0.5, 0.41, 0.405, 1e-7, 1e-14, 100.0],
                        size=(rows, nchecks))
    scales[2, 7] = np.nan
    scales[4, :] = 0.3
    u = rng.standard_normal((rows, nchecks + 1, n))
    u[3] = u[3, :1] + 1e-13 * rng.standard_normal((nchecks + 1, n))
    fu = scales[..., None] * rng.standard_normal((rows, nchecks, n))
    fu0 = rng.standard_normal((rows, n))
    abstol, reltol = 1e-6, 1e-6
    ts = ttrm.init_termination_batched(tcfg, _t(fu0), _t(u[:, 0]), reltol)
    js = [jtrm.init_termination(jcfg, jnp.asarray(fu0[r]),
                                jnp.asarray(u[r, 0]), reltol)
          for r in range(rows)]
    done = np.zeros(rows, bool)
    for i in range(nchecks):
        tstop, ts_new = ttrm.check_termination_batched(
            tcfg, ts, _t(fu[:, i]), _t(u[:, i + 1]), _t(u[:, i]),
            np.float64(abstol), np.float64(reltol), is_least_squares=lsq)
        for r in range(rows):
            if done[r]:
                continue
            jstop, js[r] = jtrm.check_termination(
                jcfg, js[r], jnp.asarray(fu[r, i]), jnp.asarray(u[r, i + 1]),
                jnp.asarray(u[r, i]), abstol, reltol, is_least_squares=lsq)
            assert bool(tstop[r]) == bool(jstop), (r, i)
            assert int(ts_new.retcode[r]) == int(js[r].retcode), (r, i)
            assert int(ts_new.nsteps[r]) == int(js[r].nsteps), (r, i)
            if tcfg.keeps_best:
                np.testing.assert_array_equal(
                    ts_new.best_u[r].numpy(), np.asarray(js[r].best_u))
        # a row that has stopped keeps its state, as in the solver's loop
        from nonlinearsolve_tpu_torch.core.lockstep import select_rows
        live = torch.tensor(~done)
        ts = select_rows(live, ts_new, ts)
        done |= tstop.numpy()

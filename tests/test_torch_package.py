"""The port's package surface: import hygiene, the device policy, the
options it refuses or runs, and the small modules that must equal the JAX
package's (return codes, tolerances, norms, termination)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.core import termination as jtrm
from nonlinearsolve_tpu.utils import norms as jnorms
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.core import termination as ttrm
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.utils import norms as tnorms

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_in_subprocess(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    code = ("import sys, nonlinearsolve_tpu_torch, "
            "nonlinearsolve_tpu_torch.interop, "
            "nonlinearsolve_tpu_torch.native, "
            "nonlinearsolve_tpu_torch.models.brusselator, "
            "nonlinearsolve_tpu_torch.ops.stencil, "
            "nonlinearsolve_tpu_torch.ops.preconditioners, "
            "nonlinearsolve_tpu_torch.ops.sparse, "
            "nonlinearsolve_tpu_torch.ops.spmv, "
            "nonlinearsolve_tpu_torch.ops.spmv_dia, "
            "nonlinearsolve_tpu_torch.ops.selection, "
            "nonlinearsolve_tpu_torch.ops.coloring, "
            "nonlinearsolve_tpu_torch.ops.sparse_jac, "
            "nonlinearsolve_tpu_torch.ops.stencil3d, "
            "nonlinearsolve_tpu_torch.models.reaction_diffusion, "
            "nonlinearsolve_tpu_torch.models.bratu, "
            "nonlinearsolve_tpu_torch.models.snes_ex2, "
            "nonlinearsolve_tpu_torch.ops.krylov, "
            "nonlinearsolve_tpu_torch.ops.direct_sparse, "
            "nonlinearsolve_tpu_torch.ops.device_lu, "
            "nonlinearsolve_tpu_torch.solvers.simple, "
            "nonlinearsolve_tpu_torch.solvers.bracketing, "
            "nonlinearsolve_tpu_torch.core.ensemble, "
            "nonlinearsolve_tpu_torch.core.sensitivity, "
            "nonlinearsolve_tpu_torch.core.bounds, "
            "nonlinearsolve_tpu_torch.core.cache, "
            "nonlinearsolve_tpu_torch.core.timer, "
            "nonlinearsolve_tpu_torch.utils.profiling, "
            "nonlinearsolve_tpu_torch.utils.ordering, "
            "nonlinearsolve_tpu_torch.ops.sparsity_trace, "
            "nonlinearsolve_tpu_torch.ops.doublef32, "
            "nonlinearsolve_tpu_torch.ops.doublef32_eval, "
            "nonlinearsolve_tpu_torch.solvers.refinement\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'nonlinearsolve_tpu'"
            " or m.startswith('nonlinearsolve_tpu.'))\n"
            "print(bad)\n")
    out = _import_in_subprocess(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py's own imports pull in neither JAX nor the JAX
    package (it exits before any work when there is no card)."""
    code = ("import sys, runpy\n"
            "try:\n"
            "    runpy.run_path('chip_smoke.py', run_name='not_main')\n"
            "except SystemExit:\n"
            "    pass\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('nonlinearsolve_tpu.')"
            " or m == 'nonlinearsolve_tpu')\n"
            "print(bad)\n")
    out = _import_in_subprocess(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_device_policy_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tbru.make_problem(16)
    with pytest.raises(RuntimeError):
        tbru.init_u0(16)
    with pytest.raises(RuntimeError):
        _backend.resolve_device(None)
    prob = tbru.make_problem(16, device="cpu")
    assert prob.u0.device.type == "cpu" and prob.p.device.type == "cpu"


@pytest.mark.parametrize("dtype,expect", [
    (torch.float32, torch.float32), ("float64", torch.float64),
    (np.float32, torch.float32), (jnp.float64, torch.float64)])
def test_resolve_dtype(dtype, expect):
    assert _backend.resolve_dtype(dtype) == expect


def test_resolve_dtype_refuses_others():
    with pytest.raises(TypeError):
        _backend.resolve_dtype(torch.bfloat16)


def _alg():
    return tnls.NewtonRaphson(linsolve=tnls.LinearSolver(method="gmres"))


@pytest.mark.parametrize("option", [
    {"show_trace": True}, {"store_trace": True}, {"trace_level": "minimal"},
    {"verbose": True}, {"time_phases": True}, {"maxtime": 1.0},
    {"precondition": lambda fu, u, p: fu},
    {"postcondition": lambda u, uprev, p: u}])
def test_unported_options_raise(option, capfd):
    """The options that raised until ROADMAP A.18 ported them now run:
    none of these changes an iterate, so each solve gives the plain
    solve's root bit for bit (``maxtime`` through the iterator)."""
    prob = tbru.make_problem(8, device="cpu")
    ref = tnls.solve(prob, tnls.NewtonRaphson(), abstol=1e-10)
    sol = tnls.solve(prob, tnls.NewtonRaphson(), abstol=1e-10, **option)
    assert sol.retcode == ref.retcode == tnls.ReturnCode.Success
    assert torch.equal(sol.u, ref.u)
    assert (sol.trace is not None) == ("store_trace" in option)
    assert (sol.timer is not None) == ("time_phases" in option)
    out = capfd.readouterr()
    assert ("iter 1:" in out.out) == ("show_trace" in option)


def test_unported_routes_raise():
    prob = tbru.make_problem(8, device="cpu")
    # bounds run since ROADMAP A.18: TrustRegion from the clamped u0 to the
    # unbounded root, as in the JAX package (NewtonRaphson from u0's zeros
    # ends Unstable in both)
    ref = tnls.solve(prob, tnls.NewtonRaphson(), abstol=1e-10)
    bounded = tnls.NonlinearProblem(prob.f, prob.u0, prob.p, lb=0.0)
    sol = tnls.solve(bounded, tnls.TrustRegion(), abstol=1e-10)
    assert sol.retcode == tnls.ReturnCode.Success
    assert float((sol.u - ref.u).abs().max()) < 1e-8
    with pytest.raises(ValueError, match="unknown linesearch"):
        tnls.solve(prob, tnls.NewtonRaphson(
            linsolve=tnls.LinearSolver(method="gmres"),
            linesearch=object()))
    # normal-form Krylov least squares runs since ROADMAP A.33, with the
    # JAX package's retcode, NLStats and root
    jlsq = jnls.NonlinearLeastSquaresProblem(
        lambda u, p: jnp.concatenate([u, u[:1]]), jnp.ones(3))
    jsol = jnls.solve(jlsq, jnls.GaussNewton(
        linsolve=jnls.LinearSolver(method="bicgstab")))
    lsq = tnls.NonlinearLeastSquaresProblem(
        lambda u, p: torch.cat([u, u[:1]]), torch.ones(3, dtype=torch.float64))
    tsol = tnls.solve(lsq, tnls.GaussNewton(           # normal-form Krylov
        linsolve=tnls.LinearSolver(method="bicgstab")))
    assert (int(tsol.retcode), tsol.stats.nsteps, tsol.stats.nf) == \
        (int(jsol.retcode), int(jsol.stats.nsteps), int(jsol.stats.nf))
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               atol=1e-12)
    # the simple solvers run since ROADMAP A.17: SimpleBroyden →
    # SimpleKlement head the ladder, as in the JAX package
    jladder = jnls.FastShortcutNonlinearPolyalg(
        prefer_simplenonlinearsolve=True)
    tladder = tnls.FastShortcutNonlinearPolyalg(
        prefer_simplenonlinearsolve=True)
    assert [type(a).__name__ for a in tladder.algs] == \
        [type(a).__name__ for a in jladder.algs]
    assert [type(a).__name__ for a in tladder.algs[:2]] == \
        ["SimpleBroyden", "SimpleKlement"]
    assert tladder.start_index == jladder.start_index == 1
    quad = tnls.NonlinearProblem(lambda u, p: u * u - p,
                                 torch.tensor([1.0, 1.5],
                                              dtype=torch.float64), 2.0)
    jsol = jnls.solve(jnls.NonlinearProblem(lambda u, p: u * u - p,
                                            jnp.array([1.0, 1.5]), 2.0),
                      jladder)
    tsol = tnls.solve(quad, tladder)
    assert tsol.counters["rungs"][0][:2] == (0, int(jsol.retcode)) == \
        (0, int(tnls.ReturnCode.Success))
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    shaped_sparse = tbru.make_problem(8, device="cpu", with_sparsity=True)
    with pytest.raises(NotImplementedError, match="ROADMAP C"):
        tnls.solve(shaped_sparse, tnls.NewtonRaphson(
            autodiff=tnls.JacobianPolicy(mode="sparse"),
            linsolve=tnls.LinearSolver(method="gmres")))
    # the sparse direct route runs since ROADMAP A.23 (on a shaped state)
    from nonlinearsolve_tpu_torch.models import bratu as tbratu
    sol = tnls.solve(tbratu.make_problem(8, device="cpu"),
                     tnls.NewtonRaphson(
                         autodiff=tnls.JacobianPolicy(mode="sparse")))
    assert sol.retcode == tnls.ReturnCode.Success
    # a 0-d state runs on the flat path since ROADMAP A.33, as in the JAX
    # package, and comes back 0-d
    jsol = jnls.solve(jnls.NonlinearProblem(lambda u, p: u - 1.0,
                                            jnp.float32(0.5)),
                      jnls.NewtonRaphson(
                          linsolve=jnls.LinearSolver(method="gmres")))
    tsol = tnls.solve(tnls.NonlinearProblem(lambda u, p: u - 1.0,
                                            torch.tensor(0.5)), _alg())
    assert tsol.u.shape == () and tsol.u.dtype == torch.float32
    assert (int(tsol.retcode), tsol.stats.nsteps, tsol.stats.nf) == \
        (int(jsol.retcode), int(jsol.stats.nsteps), int(jsol.stats.nf))
    assert float(tsol.u) == float(jsol.u)
    # differentiating through the solve runs since ROADMAP A.28: the root
    # depends on p alone, so a u0 that requires grad gets none
    grad_u0 = prob.u0.clone().requires_grad_(True)
    sol = tnls.solve(prob.remake(u0=grad_u0), tnls.NewtonRaphson(),
                     abstol=1e-10)
    assert not sol.u.requires_grad
    assert torch.equal(sol.u, ref.u)


# names the JAX package exports from a module the port has, whose
# machinery comes with a later ROADMAP item (none since A.33)
NOT_YET_EXPORTED = {}


def test_port_exports_the_jax_names_of_its_modules():
    """Every name the JAX package exports at the top level from a module
    that the port has (the same path under nonlinearsolve_tpu_torch) is
    exported by the port too (ROADMAP C.2), except the named later items;
    and every name the port exports is one the JAX package exports."""
    import importlib
    import importlib.util
    missing = {}
    for name in dir(jnls):
        obj = getattr(jnls, name)
        mod = getattr(obj, "__module__", None) or ""
        if name.startswith("_") or not mod.startswith("nonlinearsolve_tpu."):
            continue
        ported = "nonlinearsolve_tpu_torch" + mod[len("nonlinearsolve_tpu"):]
        if importlib.util.find_spec(ported) is None:
            continue
        if not hasattr(tnls, name):
            missing[name] = mod
    assert set(missing) == set(NOT_YET_EXPORTED), missing
    assert set(tnls.__all__) <= set(dir(jnls))
    # the refinement names (ROADMAP A.27) are the JAX package's, and the
    # modules of A.25 and A.27 define every public name of theirs
    assert tnls.refine_root is importlib.import_module(
        "nonlinearsolve_tpu_torch.solvers.refinement").refine_root
    assert tnls.RefineResult._fields == jnls.RefineResult._fields
    assert callable(tnls.auto_refine)
    for mod in ("ops.sparsity_trace", "ops.coloring", "ops.doublef32",
                "ops.doublef32_eval", "solvers.refinement"):
        jmod = importlib.import_module("nonlinearsolve_tpu." + mod)
        tmod = importlib.import_module("nonlinearsolve_tpu_torch." + mod)
        names = {n for n, v in vars(jmod).items() if not n.startswith("_")
                 and getattr(v, "__module__", None) == jmod.__name__}
        assert names and all(hasattr(tmod, n) for n in names), \
            (mod, sorted(n for n in names if not hasattr(tmod, n)))
    for name in tnls.__all__:
        assert hasattr(tnls, name), name
    # the C.2 names work as the JAX ones do
    assert isinstance(tnls.Dogleg(), tnls.Dogleg)
    assert tnls.pickchunksize(100) == jnls.pickchunksize(100)
    assert tnls.EisenstatWalkerForcing2 is tnls.EisenstatWalkerForcing
    for cls in (tnls.SteepestDescent, tnls.NewtonDescent,
                tnls.DampedNewtonDescent, tnls.GeodesicAcceleration):
        cls()
    # the batched tier's names (ROADMAP A.17, A.29), field for field the
    # JAX package's configs
    import dataclasses
    for name in ("SimpleNewtonRaphson", "SimpleBroyden", "SimpleKlement",
                 "SimpleDFSane", "SimpleHalley", "SimpleTrustRegion",
                 "SimpleLimitedMemoryBroyden", "Bisection", "Falsi", "Ridder",
                 "Brent", "ITP", "Alefeld", "Muller", "ModAB"):
        j, t = getattr(jnls, name)(), getattr(tnls, name)()
        assert {f.name: getattr(t, f.name) for f in dataclasses.fields(t)} \
            == {f.name: getattr(j, f.name) for f in dataclasses.fields(j)}
    assert isinstance(tnls.SimpleGaussNewton(), tnls.SimpleNewtonRaphson)
    assert tnls.SimpleNewtonRaphson.default_termination_callee == "simple"
    eprob = tnls.EnsembleProblem(tnls.NonlinearProblem(
        lambda u, p: u - p, torch.zeros(1, dtype=torch.float64)))
    assert eprob.prob_func is None
    with pytest.raises(ValueError, match="k2"):
        tnls.ITP(k2=0.5)


def test_vec_jac_operator_matches_jax():
    """VecJacOperator: v ↦ J(u)ᵀ v by the VJP, bound or not; its .T is the
    JVP."""
    A = np.random.default_rng(4).standard_normal((5, 3))
    u, v = np.linspace(0.1, 0.5, 3), np.linspace(-1.0, 1.0, 5)

    def fj(x):
        return jnp.asarray(A) @ jnp.sin(x)

    def ft(x):
        return torch.tensor(A) @ torch.sin(x)

    want = np.asarray(jnls.VecJacOperator(fj, jnp.asarray(u))(
        jnp.asarray(v)))
    op = tnls.VecJacOperator(ft)
    got = op.at(torch.tensor(u))(torch.tensor(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-14)
    bound = tnls.VecJacOperator(ft, torch.tensor(u))
    np.testing.assert_allclose(bound(torch.tensor(v)).numpy(), want,
                               rtol=1e-14)
    w = np.array([0.3, -0.2, 0.7])
    np.testing.assert_allclose(
        bound.T(torch.tensor(w)).numpy(),
        np.asarray(jnls.JacVecOperator(fj, jnp.asarray(u))(jnp.asarray(w))),
        rtol=1e-14)
    np.testing.assert_allclose((bound @ torch.tensor(v)).numpy(), want,
                               rtol=1e-14)


def test_kwargs_are_checked_and_merged():
    prob = tbru.make_problem(8, device="cpu")
    with pytest.raises(TypeError, match="abstol"):
        tnls.solve(prob, _alg(), abstoll=1.0)
    with pytest.raises(TypeError, match="ensemble"):
        tnls.solve(prob, _alg(), trajectories=2)
    # problem-level maxiters=0 is overridden by the call site
    p0 = prob.remake(maxiters=0)
    assert tnls.solve(p0, _alg()).retcode == tnls.ReturnCode.MaxIters
    assert tnls.solve(p0, _alg(), maxiters=1).stats.nsteps == 1


def test_return_codes_equal_jax():
    assert {c.name: int(c) for c in tnls.ReturnCode} == \
        {c.name: int(c) for c in jnls.ReturnCode}
    for c in jnls.ReturnCode:
        assert tnls.ReturnCode.successful(c) == \
            bool(jnls.ReturnCode.successful(int(c)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_default_tolerance_equals_jax(dtype):
    assert tnorms.default_tolerance(dtype) == jnorms.default_tolerance(dtype)
    assert tnorms.get_tolerance(None, dtype) == jnorms.get_tolerance(None,
                                                                     dtype)
    assert tnorms.get_tolerance(0.5, dtype) == 0.5


def test_norms_equal_jax():
    x = np.random.default_rng(0).standard_normal((6, 5, 2))
    x[2, 3, 1] = -9.0
    t, j = torch.tensor(x), jnp.asarray(x)
    np.testing.assert_allclose(float(tnorms.l2_norm(t)),
                               float(jnorms.l2_norm(j)), rtol=1e-14)
    assert float(tnorms.linf_norm(t)) == float(jnorms.linf_norm(j)) == 9.0
    assert tnorms.tree_size(t) == jnorms.tree_size(j) == 60
    y = np.ones_like(x)
    assert float(tnorms.apply_norm("linf", t, torch.tensor(y))) == \
        float(jnorms.apply_norm("linf", j, jnp.asarray(y)))
    nan = torch.tensor([1.0, float("nan")])
    assert np.isnan(float(tnorms.linf_norm(nan)))


def test_default_termination_mode_equals_jax():
    for lsq in (False, True):
        for callee in ("regular", "simple"):
            j = jtrm.default_termination_mode(lsq, callee)
            t = ttrm.default_termination_mode(lsq, callee)
            assert (t.mode, t.norm, t.max_stalled_steps) == \
                (j.mode, j.norm, j.max_stalled_steps)


def _term_pair(mode, **kw):
    return (jtrm.TerminationCondition(mode=mode, norm="linf", **kw),
            ttrm.TerminationCondition(mode=mode, norm="linf", **kw))


@pytest.mark.parametrize("mode,kw", [
    ("abs_norm", {}), ("abs_norm_safe", {}),
    ("abs_norm_safe_best", {"max_stalled_steps": 3}),
    ("abs_norm_safe_best", {"patience_steps": 2}),
    ("abs_norm_safe", {"protective_threshold": 1.0})])
def test_termination_sequence_equals_jax(mode, kw):
    """Feed both termination checks the same residual sequence (improving,
    stalling, then diverging/non-finite) and compare stop and retcode."""
    jcfg, tcfg = _term_pair(mode, **kw)
    rng = np.random.default_rng(5)
    u = rng.standard_normal(10)
    seq = [u]
    scales = [1.0, 0.5, 0.4, 0.41, 0.405, 0.404, 0.404, 100.0, np.nan]
    fus = [s * rng.standard_normal(10) for s in scales]
    for _ in scales:
        seq.append(seq[-1] + 1e-12 * rng.standard_normal(10))
    abstol, reltol = 1e-6, 1e-6
    js = jtrm.init_termination(jcfg, jnp.asarray(fus[0]), jnp.asarray(u),
                               reltol)
    ts = ttrm.init_termination(tcfg, torch.tensor(fus[0]), torch.tensor(u),
                               reltol)
    for i in range(1, len(scales)):
        jstop, js = jtrm.check_termination(
            jcfg, js, jnp.asarray(fus[i]), jnp.asarray(seq[i]),
            jnp.asarray(seq[i - 1]), abstol, reltol)
        tstop, ts = ttrm.check_termination(
            tcfg, ts, torch.tensor(fus[i]), torch.tensor(seq[i]),
            torch.tensor(seq[i - 1]), np.float64(abstol), reltol)
        assert tstop == bool(jstop), i
        assert ts.retcode == int(js.retcode), i
        assert ts.nsteps == int(js.nsteps), i
        if tcfg.keeps_best:
            np.testing.assert_array_equal(
                ttrm.termination_result(tcfg, ts, None).numpy(),
                np.asarray(jtrm.termination_result(jcfg, js, None)))
        if jstop:
            break

"""The SciPy bridge, the delegating constructors, user algorithms
(``run_flat``) and the continuation cache against the JAX package: the
A.30 rows of ``tests/test_interfaces.py`` and
``test_homotopy_cache_init_reinit_solve`` of
``tests/test_homotopy_scc.py``, f64 on the CPU.

The SciPy rows run the same ``scipy.optimize`` call on both packages'
callbacks: roots within 1e-10 of the JAX package's bridge and the same
success, besides the JAX test's bounds.  The constructors return the same
native configuration as the JAX package's (field for field).  A user
algorithm gives the JAX package's retcode, NLStats and root, and its
implicit-function derivative within rel 1e-10.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.solvers import wrappers as jwr
from nonlinearsolve_tpu_torch.core import verbosity as tvrb
from nonlinearsolve_tpu_torch.solvers import wrappers as twr

torch.set_num_threads(1)

STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def t64(x):
    return torch.tensor(x, dtype=torch.float64)


def quadratic(u, p):
    return u * u - p


def both_root(alg):
    jsol = jnls.solve(jnls.NonlinearProblem(quadratic, jnp.array([1.0, 1.0]),
                                            2.0), alg(jnls))
    tsol = tnls.solve(tnls.NonlinearProblem(quadratic, t64([1.0, 1.0]), 2.0),
                      alg(tnls))
    assert tsol.success == bool(jsol.success)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-10)
    return tsol


@pytest.mark.parametrize("method", ["hybr", "lm", "df-sane", "broyden1"])
def test_scipy_root_method_conformance(method):
    """``test_scipy_root_conformance`` and
    ``test_scipy_root_method_conformance``: the bridge lands on the native
    root."""
    sol = both_root(lambda m: m.SciPyRoot(method=method))
    native = tnls.solve(tnls.NonlinearProblem(quadratic, t64([1.0, 1.0]),
                                              2.0), tnls.NewtonRaphson())
    assert sol.success
    np.testing.assert_allclose(sol.u.numpy(), native.u.numpy(), rtol=1e-6)
    np.testing.assert_allclose(sol.u.numpy(), np.sqrt(2.0), rtol=1e-6)
    assert isinstance(sol.original.x, np.ndarray) and sol.stats.nf > 0


TS = np.linspace(0, 1, 8)
DATA = 2.0 * np.exp(-1.5 * TS)


@pytest.mark.parametrize("alg", ["SciPyLeastSquares", "SciPyLeastSquaresTRF",
                                 "SciPyLeastSquaresDogbox"])
def test_scipy_least_squares(alg):
    jsol = jnls.solve(jnls.NonlinearLeastSquaresProblem(
        lambda u, p: u[0] * jnp.exp(u[1] * jnp.asarray(TS)) - jnp.asarray(
            DATA), jnp.array([1.0, -1.0])), getattr(jnls, alg)())
    tsol = tnls.solve(tnls.NonlinearLeastSquaresProblem(
        lambda u, p: u[0] * torch.exp(u[1] * torch.as_tensor(TS))
        - torch.as_tensor(DATA), t64([1.0, -1.0])), getattr(tnls, alg)())
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(tsol.u.numpy(), [2.0, -1.5], rtol=1e-6)
    assert tsol.stats.nf == int(jsol.stats.nf)


def test_scipy_root_scalar():
    """The bracket's tensors decide the device and dtype."""
    jsol = jnls.solve(jnls.IntervalNonlinearProblem(
        lambda u, p: u * u - 2.0, (1.0, 2.0)), jnls.SciPyRootScalar())
    tsol = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, p: u * u - 2.0, (t64(1.0), t64(2.0))),
        tnls.SciPyRootScalar())
    assert tsol.success and tsol.u.dtype == torch.float64
    assert float(tsol.u) == float(jsol.u)
    assert abs(float(tsol.u) - np.sqrt(2.0)) <= 1e-10 * np.sqrt(2.0)
    with pytest.raises(TypeError, match="IntervalNonlinearProblem"):
        twr.solve_wrapper(tnls.NonlinearProblem(quadratic, t64([1.0]), 2.0),
                          tnls.SciPyRootScalar())


def _fields(obj):
    return {f.name: _fields(getattr(obj, f.name))
            if dataclasses.is_dataclass(getattr(obj, f.name))
            else getattr(obj, f.name) for f in dataclasses.fields(obj)}


CONSTRUCTORS = [
    ("CMINPACK", dict(method=":lm")), ("CMINPACK", dict(method="hybr")),
    ("NLsolveJL", dict(method=":anderson", m=8)),
    ("NLsolveJL", dict(method="broyden")), ("NLsolveJL", {}),
    ("NLsolveJL", dict(method="newton")),
    ("KINSOL", dict(globalization_strategy="fixedpoint", m=3)),
    ("KINSOL", dict(globalization_strategy="linesearch")), ("KINSOL", {}),
    ("SpeedMappingJL", {}), ("FixedPointAccelerationJL",
                            dict(algorithm=":Aitken")),
    ("FixedPointAccelerationJL", dict(algorithm="newton")),
    ("NLSolversJL", dict(method="newton_hagerzhang")),
    ("NLSolversJL", dict(method="newton_morethuente")),
    ("SIAMFANLEquationsJL", dict(method=":pseudotransient")),
    ("SIAMFANLEquationsJL", dict(method="anderson", m=2)),
    ("LeastSquaresOptimJL", dict(alg="dogleg")), ("LeastSquaresOptimJL", {}),
    ("FastLevenbergMarquardtJL", dict(factor=2.0)),
    ("PETScSNES", {}), ("PETScSNES", dict(snes_type="newtontr")),
    ("PETScSNES", dict(snes_type="qn")),
]


@pytest.mark.parametrize("name,kw", CONSTRUCTORS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(CONSTRUCTORS)])
def test_extension_alg_constructors_delegate_natively(name, kw):
    """Each delegating constructor returns the native algorithm the JAX
    package's returns, field for field."""
    j, t = getattr(jnls, name)(**kw), getattr(tnls, name)(**kw)
    assert type(t).__name__ == type(j).__name__
    assert _fields(t) == _fields(j)


def test_extension_alg_constructors_solve():
    """The JAX test's solves through the delegated algorithms."""
    from nonlinearsolve_tpu_torch.core.wolfe_linesearch import HagerZhang
    assert tnls.CMINPACK(method="hybr").trustregion is not None
    assert tnls.NLsolveJL(method=":anderson", m=8).m == 8
    assert isinstance(tnls.NLsolveJL(method="broyden"),
                      tnls.QuasiNewtonAlgorithm)
    assert tnls.NLsolveJL().trustregion.method == "nlsolve"
    assert isinstance(tnls.NLSolversJL("newton_hagerzhang").linesearch,
                      HagerZhang)
    with pytest.raises(ValueError, match="unknown NLSolversJL"):
        tnls.NLSolversJL("bogus")
    for name, kw in [("PETScSNES", {}), ("PETScSNES", dict(snes_type=
                                                            "newtontr")),
                     ("KINSOL", {}), ("CMINPACK", {}), ("NLsolveJL", {}),
                     ("SIAMFANLEquationsJL", dict(method=":pseudotransient")),
                     ("FastLevenbergMarquardtJL", {})]:
        sol = tnls.solve(tnls.NonlinearProblem(quadratic, t64([1.0, 1.0]),
                                               2.0), getattr(tnls, name)(**kw))
        assert sol.retcode == tnls.ReturnCode.Success
        np.testing.assert_allclose(sol.u.numpy(), np.sqrt(2.0), rtol=1e-6)


def test_extension_constructor_dropped_kwarg_notice(capfd):
    tnls.NLsolveJL(autoscale=False)
    err = capfd.readouterr().err
    assert "dropped_extension_kwarg" in err and "autoscale" in err
    tnls.PETScSNES(snes_type="newtontr", snes_linesearch_type="l2")
    assert "snes_linesearch_type" in capfd.readouterr().err
    tnls.CMINPACK(method="lm")
    tnls.FastLevenbergMarquardtJL(factor=2.0)
    assert capfd.readouterr().err == ""
    # the JAX package prints the same notice
    jnls.NLsolveJL(autoscale=False)
    jerr = capfd.readouterr().err
    tnls.NLsolveJL(autoscale=False)
    assert capfd.readouterr().err.replace("_torch", "") == jerr
    old = twr.CONSTRUCTOR_VERBOSITY
    try:
        twr.CONSTRUCTOR_VERBOSITY = tvrb.NonlinearVerbosity("none")
        tnls.NLsolveJL(autoscale=False)
        assert capfd.readouterr().err == ""
    finally:
        twr.CONSTRUCTOR_VERBOSITY = old


def test_dropped_kwarg_reports_explicit_none(capfd):
    twr.KINSOL(krylov_dim=None)
    out = capfd.readouterr()
    assert "krylov_dim" in out.err + out.out
    jwr.KINSOL(krylov_dim=None)
    capfd.readouterr()


class _Richardson:
    """The JAX test's user algorithm, on each package's fixed-point loop."""
    name = "Richardson"

    def __init__(self, loop, omega=0.3):
        self.loop, self.omega = loop, omega

    def __hash__(self):
        return hash(("Richardson", self.omega))

    def __eq__(self, o):
        return isinstance(o, _Richardson) and o.omega == self.omega

    def run_flat(self, ctx, term_cfg, u0_flat, abstol, reltol, maxiters):
        def step(u, fu, state):
            return u - self.omega * fu, state
        return self.loop(step, ctx, term_cfg, u0_flat, abstol, reltol,
                         maxiters)


def test_custom_algorithm_extension():
    """A ``run_flat`` algorithm dispatches through ``solve`` and is
    differentiable by the implicit-function rule."""
    from nonlinearsolve_tpu.solvers.custom import \
        run_fixed_point_loop as jloop
    from nonlinearsolve_tpu_torch.solvers.custom import \
        run_fixed_point_loop as tloop
    jsol = jnls.solve(jnls.NonlinearProblem(
        lambda u, p: u + 0.3 * jnp.tanh(u) - p, jnp.zeros(5),
        0.7 * jnp.ones(5)), _Richardson(jloop), maxiters=500)
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: u + 0.3 * torch.tanh(u) - p,
        torch.zeros(5, dtype=torch.float64),
        0.7 * torch.ones(5, dtype=torch.float64)), _Richardson(tloop),
        maxiters=500)
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tuple(getattr(tsol.stats, k) for k in STATS) == tuple(
        int(getattr(jsol.stats, k)) for k in STATS)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-12)
    assert tsol.success and float(tsol.resid.abs().max()) < 1e-10

    jg = jax.grad(lambda p: jnls.solve(jnls.NonlinearProblem(
        lambda u, q: u + 0.3 * jnp.tanh(u) - q, jnp.zeros(1), p),
        _Richardson(jloop), maxiters=500).u[0])(jnp.array([0.7]))
    p = t64([0.7]).requires_grad_(True)
    u = tnls.solve(tnls.NonlinearProblem(
        lambda u, q: u + 0.3 * torch.tanh(u) - q,
        torch.zeros(1, dtype=torch.float64), p), _Richardson(tloop),
        maxiters=500).u[0]
    g, = torch.autograd.grad(u, p)
    assert abs(float(g[0]) - float(jg[0])) <= 1e-10 * abs(float(jg[0]))
    assert 0.7 < float(g[0]) < 0.9


def test_null_u0_solutions():
    """``u0=None`` solves at once: an empty f64 state on p's device."""
    s = tnls.solve(tnls.NonlinearProblem(quadratic, None, t64(2.0)))
    j = jnls.solve(jnls.NonlinearProblem(quadratic, None, 2.0))
    assert int(s.retcode) == int(j.retcode) == int(tnls.ReturnCode.Success)
    assert s.u.shape == (0,) and s.u.dtype == torch.float64
    assert s.stats == tnls.NLStats()
    big = tnls.solve(tnls.NonlinearLeastSquaresProblem(
        lambda u, p: t64([3.0]), None, t64(0.0)))
    assert big.retcode == tnls.ReturnCode.Failure


def H_quad(u, p, lam):
    return (1 - lam) * (u - p) + lam * (u ** 2 - p)


def test_homotopy_cache_iteration_messages():
    """The continuation cache explains its whole-solve granularity."""
    prob = tnls.HomotopyProblem(lambda u, lam, p: u ** 3 - u - lam,
                                t64([1.0]), None)
    cache = tnls.init(prob)
    with pytest.raises(NotImplementedError, match="whole-solve"):
        cache.step()
    with pytest.raises(NotImplementedError, match="whole-solve"):
        iter(cache)


CACHE_ALGS = [
    lambda m: m.HomotopySweep(inner=m.NewtonRaphson(), adaptive=False,
                              nsteps=10),
    lambda m: m.KantorovichHomotopy(inner=m.NewtonRaphson(), nsteps=10,
                                    strict=False),
    lambda m: m.HomotopySweep(adaptive=False, nsteps=10)]


@pytest.mark.parametrize("k", range(len(CACHE_ALGS)),
                         ids=["sweep", "kantorovich", "sweep-default-inner"])
def test_homotopy_cache_init_reinit_solve(k):
    """``init`` / ``reinit`` / ``solve``: a reinit swaps (u0, p, abstol)
    and the next solve lands on the new problem's root at the new
    tolerance; the JAX package's codes and counts where its plan is a
    NewtonRaphson inner (the default inner: the port alone)."""
    make = CACHE_ALGS[k]
    tcache = tnls.init(tnls.HomotopyProblem(H_quad, t64([4.0]), t64(4.0)),
                       make(tnls), abstol=1e-3)
    assert isinstance(tcache, tnls.core.cache.HomotopySolveCache)
    assert tcache.reinit(t64([4.0]), p=t64(4.0), abstol=1e-10) is tcache
    runs = [(t64([4.0]), t64(4.0), 2.0), (t64([9.0]), t64(9.0), 3.0)]
    for i, (u0, p, root) in enumerate(runs):
        if i:
            assert tcache.reinit(u0, p=p, abstol=1e-10) is tcache
        sol = tcache.solve()
        assert sol.success and abs(float(sol.u[0]) - root) <= 1e-10
        if k == 2:
            continue
        jcache = jnls.init(jnls.HomotopyProblem(
            H_quad, jnp.asarray(u0.numpy()), jnp.asarray(p.numpy())),
            make(jnls), abstol=1e-3)
        jcache.reinit(abstol=1e-10)
        jsol = jcache.solve()
        assert int(sol.retcode) == int(jsol.retcode)
        assert tuple(getattr(sol.stats, s) for s in STATS) == tuple(
            int(getattr(jsol.stats, s)) for s in STATS)
        assert abs(float(sol.u[0]) - float(jsol.u[0])) <= 1e-10
    tcache.reinit(lambdaspan=(0.0, 0.5))
    half = tcache.solve()
    assert half.success and float(half.original) == 0.5

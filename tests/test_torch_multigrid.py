"""Multigrid and the matrix-product DFT / hybrid spectral preconditioners
(``ops/multigrid.py``, ``ops/preconditioners.py``, ROADMAP A.24) against
the JAX package on the CPU.

- The V-cycle apply against ``multigrid_preconditioner`` in 2D (16²) and 3D
  (8³), periodic and Dirichlet, Jacobi and Chebyshev, ``c`` None, a number
  and a field, cycles 1 and 2: rel 1e-12 in f64 (the same operations in the
  same order; XLA may contract a multiply-add), 1e-5 in f32.
- ``TestMultigrid`` of ``tests/test_sparse_krylov.py``: GMRES iteration
  counts equal the JAX package's, and the Newton run's NLStats.
- ``_dft_matrices`` within 2 f32 ulps (torch's and XLA's cos / sin round
  apart) and its n > 46340 error; ``_resolve_precision``'s names.
- The mxu and hybrid applies at every precision name against the JAX
  package's (rel 1e-5: f32 products summed in another order); the hybrid
  gate takes the JAX package's branch on both sides of ``switch_abs``;
  Newton–GMRES on the 32² f32 Brusselator under both, with the JAX
  package's retcode and NLStats.
- The ``wants_residual`` contract's ``TypeError``, and
  ``fft_poisson_preconditioner(component_axis=...)`` (accepted and not
  read, as in the JAX package).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.ops import krylov as jkry
from nonlinearsolve_tpu.ops import multigrid as jmg
from nonlinearsolve_tpu.ops import preconditioners as jpre
from nonlinearsolve_tpu.solvers.first_order import \
    EisenstatWalkerForcing as JEW
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.ops import krylov as tkry
from nonlinearsolve_tpu_torch.ops import multigrid as tmg
from nonlinearsolve_tpu_torch.ops import preconditioners as tpre

torch.set_num_threads(1)

PRECISIONS = [None, "default", "bf16", "high", "highest", "f32", "HIGH"]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _stats(sol):
    s = sol.stats
    return [int(s.nf), int(s.njacs), int(s.nfactors), int(s.nsolve),
            int(s.nsteps)]


def _c_of(kind, shape, rng):
    """The coefficient in both packages' types: None, a number, a field."""
    if kind == "none":
        return None, None
    if kind == "scalar":
        return 3.0, 3.0
    field = 1.0 + 2.0 * rng.random(shape)
    return jnp.asarray(field), torch.tensor(field)


# ---------------------------------------------------------------------------
# the V-cycle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16), (8, 8, 8)])
@pytest.mark.parametrize("bc", ["periodic", "dirichlet"])
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("c_kind", ["none", "scalar", "field"])
def test_vcycle_matches_jax(shape, bc, smoother, c_kind):
    rng = np.random.default_rng(len(shape) * 7 + len(bc))
    jc, tc = _c_of(c_kind, shape, rng)
    v = rng.standard_normal(shape)
    h = 1.0 / shape[0]
    for cycles in (1, 2):
        kw = dict(bc=bc, smoother=smoother, cycles=cycles)
        ref = jmg.multigrid_preconditioner(shape, 10.0, h, c=jc, **kw)(
            jnp.asarray(v.reshape(-1)))
        got = tmg.multigrid_preconditioner(shape, 10.0, h, c=tc, **kw)(
            torch.tensor(v.reshape(-1)))
        assert got.shape == (v.size,) and got.dtype == torch.float64
        assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("levels,omega", [(None, 2.0 / 3.0), (2, 0.8)])
def test_vcycle_f32_and_options_match_jax(levels, omega):
    """f32 (rel 1e-5), a shaped input, and ``levels`` / ``omega`` given."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal((32, 32)).astype(np.float32)
    kw = dict(bc="dirichlet", c=2.0, levels=levels, omega=omega)
    ref = jmg.multigrid_preconditioner((32, 32), 1.0, 1 / 32, **kw)(
        jnp.asarray(v))
    got = tmg.multigrid_preconditioner((32, 32), 1.0, 1 / 32, **kw)(
        torch.tensor(v))
    assert got.dtype == torch.float32 and got.shape == (32, 32)
    assert _rel(got.numpy(), ref) <= 1e-5


def test_restrict_prolong_lap_match_jax():
    rng = np.random.default_rng(2)
    u = rng.standard_normal((8, 8, 4))
    np.testing.assert_allclose(tmg._restrict(torch.tensor(u)).numpy(),
                               np.asarray(jmg._restrict(jnp.asarray(u))),
                               rtol=1e-14, atol=0)
    assert np.array_equal(tmg._prolong(torch.tensor(u)).numpy(),
                          np.asarray(jmg._prolong(jnp.asarray(u))))
    for bc in ("periodic", "dirichlet"):
        np.testing.assert_allclose(
            tmg._lap(torch.tensor(u), bc).numpy(),
            np.asarray(jmg._lap(jnp.asarray(u), bc)), rtol=0, atol=1e-14)


# ---------------------------------------------------------------------------
# TestMultigrid (tests/test_sparse_krylov.py:541-616)
# ---------------------------------------------------------------------------

def _dirichlet_ops(N, cfield):
    """The JAX test's operator A u = Δ_h u − c·u (Dirichlet), in both
    packages."""
    h = 1.0 / N

    def jlap(u):
        out = -4.0 * u
        out = out.at[1:, :].add(u[:-1, :])
        out = out.at[:-1, :].add(u[1:, :])
        out = out.at[:, 1:].add(u[:, :-1])
        out = out.at[:, :-1].add(u[:, 1:])
        return out

    def tlap(u):
        out = -4.0 * u
        out[1:, :] += u[:-1, :]
        out[:-1, :] += u[1:, :]
        out[:, 1:] += u[:, :-1]
        out[:, :-1] += u[:, 1:]
        return out

    jc, tc = jnp.asarray(cfield), torch.tensor(cfield)
    return ((lambda u: (1.0 / h ** 2) * jlap(u) - jc * u),
            (lambda u: (1.0 / h ** 2) * tlap(u) - tc * u), h, jc, tc)


def _gmres_pair(N, precs, maxiter):
    """GMRES(30) at rtol 1e-8 on the 64² variable-coefficient problem,
    unpreconditioned or with the given multigrid options, in both
    packages: [(jax iterations, port iterations, port result)]."""
    rng = np.random.default_rng(0)
    cfield = 1.0 + 2.0 * rng.random((N, N))
    JA, TA, h, jc, tc = _dirichlet_ops(N, cfield)
    b = rng.standard_normal((N, N))
    out = []
    for kw in precs:
        jM = tM = None
        if kw is not None:
            jM = jmg.multigrid_preconditioner((N, N), 1.0, h, c=jc,
                                              bc="dirichlet", **kw)
            tM = tmg.multigrid_preconditioner((N, N), 1.0, h, c=tc,
                                              bc="dirichlet", **kw)
        rj = jkry.gmres(JA, jnp.asarray(b), restart=30, rtol=1e-8,
                        maxiter=maxiter, M=jM)
        rt = tkry.gmres(TA, torch.tensor(b), restart=30, rtol=1e-8,
                        maxiter=maxiter, M=tM)
        out.append((int(rj.iterations), rt.iterations, rt, bool(rj.success)))
    return out, TA, torch.tensor(b)


class TestMultigrid:
    def test_iteration_reduction_2d(self):
        (r0, r1), TA, b = _gmres_pair(64, [None, {}], 3000)
        assert r0[0] == r0[1] and r1[0] == r1[1]
        assert r1[2].success and r1[3]
        assert r1[1] < r0[1] // 5
        rel = float(torch.linalg.norm(TA(r1[2].x) - b)
                    / torch.linalg.norm(b))
        assert rel < 1e-6

    def test_chebyshev_smoother(self):
        (rj, rc), _, _ = _gmres_pair(
            64, [{"smoother": "jacobi"}, {"smoother": "chebyshev", "nu": 3}],
            500)
        assert rj[0] == rj[1] and rc[0] == rc[1]
        assert rc[2].success and rc[1] <= rj[1]

    def test_newton_krylov_with_mg(self):
        N = 32
        h = 1.0 / N
        g = np.random.default_rng(1).standard_normal((N, N))

        def jf(u, p):
            out = -4.0 * u
            out = out.at[1:, :].add(u[:-1, :])
            out = out.at[:-1, :].add(u[1:, :])
            out = out.at[:, 1:].add(u[:, :-1])
            out = out.at[:, :-1].add(u[:, 1:])
            return (1.0 / h ** 2) * out - u ** 3 - u + p

        def tf(u, p):
            lap = -4.0 * u
            lap = lap + torch.cat([u.new_zeros(1, N), u[:-1, :]], 0)
            lap = lap + torch.cat([u[1:, :], u.new_zeros(1, N)], 0)
            lap = lap + torch.cat([u.new_zeros(N, 1), u[:, :-1]], 1)
            lap = lap + torch.cat([u[:, 1:], u.new_zeros(N, 1)], 1)
            return (1.0 / h ** 2) * lap - u ** 3 - u + p

        jM = jmg.multigrid_preconditioner((N, N), 1.0, h, c=1.0,
                                          bc="dirichlet")
        tM = tmg.multigrid_preconditioner((N, N), 1.0, h, c=1.0,
                                          bc="dirichlet")
        jsol = jnls.solve(jnls.NonlinearProblem(jf, jnp.zeros((N, N)),
                                                jnp.asarray(g)),
                          jnls.NewtonRaphson(linsolve=jnls.LinearSolver(
                              method="gmres", restart=20,
                              precond_fn=lambda u: jM)), abstol=1e-9)
        tsol = tnls.solve(tnls.NonlinearProblem(tf, torch.zeros(N, N,
                                                dtype=torch.float64),
                                                torch.tensor(g)),
                          tnls.NewtonRaphson(linsolve=tnls.LinearSolver(
                              method="gmres", restart=20,
                              precond_fn=lambda u: tM)), abstol=1e-9)
        assert tsol.retcode == tnls.ReturnCode.Success
        assert int(tsol.retcode) == int(jsol.retcode)
        assert _stats(tsol) == _stats(jsol)
        assert float(tsol.resid.abs().max()) < 1e-9
        np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                                   rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# the matrix-product DFT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 8, 33, 100, 512])
def test_dft_matrices_match_jax(n):
    jc, js = jpre._dft_matrices(n)
    tc, ts = tpre._dft_matrices(n, device="cpu")
    assert tc.dtype == torch.float32 and tuple(tc.shape) == (n, n)
    for a, b in ((tc, jc), (ts, js)):
        b = np.asarray(b)
        ulp = np.spacing(np.maximum(np.abs(b), np.float32(1e-30)))
        assert np.all(np.abs(a.numpy() - b) <= 2 * ulp)
    c64, _ = tpre._dft_matrices(n, torch.float64, device="cpu")
    assert c64.dtype == torch.float64


def test_dft_matrices_refuse_int32_overflow():
    for mod in (jpre, tpre):
        with pytest.raises(ValueError, match="46340"):
            mod._dft_matrices(46341)


def test_resolve_precision_names():
    want = {None: "medium", "default": "medium", "bf16": "medium",
            "high": "high", "highest": "highest", "f32": "highest",
            "HIGH": "high", "Highest": "highest"}
    for name, torch_name in want.items():
        assert tpre._resolve_precision(name) == torch_name
        jpre._resolve_precision(name)          # the JAX package accepts it
    for bad in ("medium", "fp16", 3):
        with pytest.raises(ValueError, match="expected one of"):
            tpre._resolve_precision(bad)
        with pytest.raises(ValueError, match="expected one of"):
            jpre._resolve_precision(bad)


def test_cpu_products_leave_matmul_precision_alone():
    """On the CPU the products are IEEE f32 whatever the name: no torch
    setting is changed, before, during or after."""
    before = torch.get_float32_matmul_precision()
    seen = []
    real = torch.tensordot

    def spy(*a, **k):
        seen.append(torch.get_float32_matmul_precision())
        return real(*a, **k)

    prep = tpre.mxu_poisson_preconditioner((8, 8), 1.0, 0.125,
                                           precision="bf16")
    v = torch.randn(64, generator=torch.Generator().manual_seed(0))
    torch.tensordot = spy
    try:
        out = prep(v)(v)
    finally:
        torch.tensordot = real
    assert seen and set(seen) == {before}
    assert torch.get_float32_matmul_precision() == before
    exact = tpre.fft_poisson_preconditioner((8, 8), 1.0, 0.125)(v)
    assert _rel(out.numpy(), exact.numpy()) <= 1e-5


@pytest.mark.parametrize("shape,nc", [((16, 16), 1), ((16, 16), 2),
                                      ((8, 8, 8), 3)])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_mxu_apply_matches_jax(shape, nc, precision):
    rng = np.random.default_rng(3)
    full = shape + ((nc,) if nc > 1 else ())
    v = rng.standard_normal(full).reshape(-1)
    kw = dict(shift=-0.9, n_components=nc, precision=precision)
    ref = jpre.mxu_poisson_preconditioner(shape, 0.01, 1 / 16, **kw)()(
        jnp.asarray(v))
    prep = tpre.mxu_poisson_preconditioner(shape, 0.01, 1 / 16, **kw)
    got = prep(torch.tensor(v))(torch.tensor(v))
    assert got.dtype == torch.float64 and got.shape == (v.size,)
    assert _rel(got.numpy(), ref) <= 1e-5
    v32 = torch.tensor(v, dtype=torch.float32)
    got32 = prep(v32)(v32)
    assert got32.dtype == torch.float32
    assert _rel(got32.numpy(), ref) <= 1e-5


def _hybrid_pair(shape, nc, switch_abs, precision):
    kw = dict(shift=3.0, n_components=nc, switch_abs=switch_abs,
              loose_precision=precision)
    return (jpre.hybrid_poisson_preconditioner(shape, 10.0, 1 / 15, **kw),
            tpre.hybrid_poisson_preconditioner(shape, 10.0, 1 / 15, **kw))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_hybrid_apply_and_gate_match_jax(precision):
    """Both sides of the gate (‖fu‖∞ 2.5 against switch_abs 1.0 and 5.0):
    the port's apply equals the JAX package's, the loose branch is the
    mxu apply and the exact one the FFT apply."""
    shape, nc = (16, 16), 2
    rng = np.random.default_rng(4)
    v = rng.standard_normal(shape + (nc,)).reshape(-1)
    fu = rng.uniform(-2.5, 2.5, v.size)
    fu[7] = -2.5
    tv, tfu = torch.tensor(v), torch.tensor(fu)
    mxu = tpre.mxu_poisson_preconditioner(
        shape, 10.0, 1 / 15, shift=3.0, n_components=nc,
        precision=precision)(tv)(tv)
    fft = tpre.fft_poisson_preconditioner(shape, 10.0, 1 / 15, shift=3.0,
                                          n_components=nc)(tv)
    for switch, branch in ((1.0, mxu), (5.0, fft)):
        jprep, tprep = _hybrid_pair(shape, nc, switch, precision)
        assert tprep.wants_residual is True
        ref = jprep(jnp.asarray(v), jnp.asarray(fu))(jnp.asarray(v))
        got = tprep(tv, tfu)(tv)
        assert _rel(got.numpy(), ref) <= 1e-5
        assert torch.equal(got, branch)


def test_hybrid_gate_reads_the_flattened_pytree_residual():
    _, tprep = _hybrid_pair((8, 8), 1, 1.0, None)
    exact = tpre.fft_poisson_preconditioner((8, 8), 10.0, 1 / 15,
                                            shift=3.0)
    v = torch.randn(64, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    small = {"a": torch.full((3,), 0.5), "b": torch.tensor([-0.9])}
    big = {"a": torch.full((3,), 0.5), "b": torch.tensor([-1.5])}
    assert torch.equal(tprep(v, small)(v), exact(v))
    assert not torch.equal(tprep(v, big)(v), exact(v))


def _brusselator_32(precond_j, precond_t):
    """Newton–GMRES(8), η 0.1, on the 32² f32 Brusselator (bench.py's
    operating point at 32², abstol 0.05: the f32 floor there), in both
    packages."""
    N = 32
    jalg = jnls.NewtonRaphson(
        linsolve=jnls.LinearSolver(method="gmres", restart=8,
                                   krylov_maxiter=100, precond_fn=precond_j),
        forcing=JEW(eta_0=0.1, eta_max=0.1))
    talg = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=8,
                                   krylov_maxiter=100, precond_fn=precond_t),
        forcing=tnls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    jprob = jbru.make_problem(N, jnp.float32)
    tprob = tbru.problem(tbru.init_u0(N, torch.float32, device="cpu"),
                         tbru.default_p(N, torch.float32, device="cpu"))
    jsol = jnls.solve(jprob, jalg, abstol=0.05, maxiters=30)
    tsol = tnls.solve(tprob, talg, abstol=0.05, maxiters=30)
    return jsol, tsol


@pytest.mark.parametrize("kind", ["mxu", "hybrid"])
def test_brusselator_newton_under_spectral_factories(kind):
    N = 32
    kw = dict(shift=3.0, n_components=2)
    if kind == "mxu":
        jp = jpre.mxu_poisson_preconditioner((N, N), 10.0, 1 / (N - 1),
                                             precision="highest", **kw)
        tp = tpre.mxu_poisson_preconditioner((N, N), 10.0, 1 / (N - 1),
                                             precision="highest", **kw)
    else:
        u0 = tbru.init_u0(N, torch.float32, device="cpu")
        f0 = tbru.brusselator_2d(u0, tbru.default_p(N, torch.float32,
                                                    device="cpu"))
        switch = 0.1 * float(f0.abs().max())
        jp = jpre.hybrid_poisson_preconditioner(
            (N, N), 10.0, 1 / (N - 1), switch_abs=switch, **kw)
        tp = tpre.hybrid_poisson_preconditioner(
            (N, N), 10.0, 1 / (N - 1), switch_abs=switch, **kw)
    jsol, tsol = _brusselator_32(jp, tp)
    assert int(tsol.retcode) == int(jsol.retcode)
    assert _stats(tsol) == _stats(jsol)
    assert tsol.u.dtype == torch.float32
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               rtol=0, atol=1e-3)


# ---------------------------------------------------------------------------
# the wants_residual contract and the component_axis repair
# ---------------------------------------------------------------------------

def test_wants_residual_factory_must_return_a_callable():
    def bad(u, fu):
        return fu

    bad.wants_residual = True
    prob_t = tnls.NonlinearProblem(lambda u, p: u * u - 2.0,
                                   torch.ones(4, dtype=torch.float64))
    prob_j = jnls.NonlinearProblem(lambda u, p: u * u - 2.0, jnp.ones(4))
    with pytest.raises(TypeError, match="wants_residual"):
        tnls.solve(prob_t, tnls.NewtonRaphson(linsolve=tnls.LinearSolver(
            method="gmres", precond_fn=bad)))
    with pytest.raises(TypeError, match="wants_residual"):
        jnls.solve(prob_j, jnls.NewtonRaphson(linsolve=jnls.LinearSolver(
            method="gmres", precond_fn=bad)))

    calls = []

    def good(u, fu):
        calls.append(float(fu.abs().max()))
        return lambda v: v

    good.wants_residual = True
    sol = tnls.solve(prob_t, tnls.NewtonRaphson(linsolve=tnls.LinearSolver(
        method="gmres", precond_fn=good)))
    assert sol.retcode == tnls.ReturnCode.Success
    assert len(calls) == sol.stats.nsteps and calls[0] == 1.0


@pytest.mark.parametrize("nc", [1, 2, 3])
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_fft_component_axis_is_accepted_and_ignored(nc, axis):
    shape = (8, 12)
    rng = np.random.default_rng(nc)
    v = rng.standard_normal(shape + ((nc,) if nc > 1 else ())).reshape(-1)
    ref = jpre.fft_poisson_preconditioner(
        shape, 0.5, 0.1, shift=2.0, n_components=nc,
        component_axis=axis)(jnp.asarray(v))
    got = tpre.fft_poisson_preconditioner(
        shape, 0.5, 0.1, shift=2.0, n_components=nc,
        component_axis=axis)(torch.tensor(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-14)
    trailing = tpre.fft_poisson_preconditioner(
        shape, 0.5, 0.1, shift=2.0, n_components=nc)(torch.tensor(v))
    assert torch.equal(got, trailing)

"""The polynomial continuation drivers (``solvers/poly_homotopy.py``,
``multistart.py``, ``homotopy_continuation.py``) against the JAX package,
f64 / complex128 on the CPU.

The cheap cases of ``tests/test_poly_homotopy.py`` and
``tests/test_homotopy_continuation_jl.py`` (the cubic, the 2×2 system,
nearest-root selection, the parametrised polynomial, the quadratic
HomotopyContinuationJL cases, the Taylor variant on sin u − ½) run in both
packages: the same retcode, the root sets sorted within 1e-8, and for the
tracker every endpoint and success flag and the summed path steps
(the paths' arithmetic is the JAX package's, op for op).  The lockstep
batch is held to its lone tracks bit for bit.  The costlier cases
(Wilkinson-6, the multistart systems) are held to the JAX tests' own
assertions.  Residuals take one path's complex state and are written with
``torch.stack`` (they run under ``torch.func.vmap``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.solvers import poly_homotopy as jph
from nonlinearsolve_tpu.solvers.homotopy_continuation import \
    measure_polynomial_degrees as j_measure
from nonlinearsolve_tpu_torch.solvers import poly_homotopy as tph
from nonlinearsolve_tpu_torch.solvers.homotopy_continuation import \
    measure_polynomial_degrees as t_measure

torch.set_num_threads(1)

F64 = torch.float64


def _t(x, dtype=F64):
    return torch.tensor(x, dtype=dtype)


def _sorted_rows(u):
    u = np.atleast_2d(np.asarray(u))
    return u[np.lexsort(np.round(u.T, 6)[::-1])] if u.size else u


POLY_CASES = {
    "cubic": (lambda x, p: jnp.array([x[0] ** 3 - 1.0]),
              lambda x, p: torch.stack([x[0] ** 3 - 1.0]),
              [1.0], None, (3,), {}),
    "system2x2": (lambda x, p: jnp.array([x[0] ** 2 + x[1] ** 2 - 5.0,
                                          x[0] * x[1] - 2.0]),
                  lambda x, p: torch.stack([x[0] ** 2 + x[1] ** 2 - 5.0,
                                            x[0] * x[1] - 2.0]),
                  [1.0, 1.0], None, (2, 2), {"real_only": True}),
    "nearest": (lambda x, p: jnp.array([x[0] ** 2 + x[1] ** 2 - 5.0,
                                        x[0] * x[1] - 2.0]),
                lambda x, p: torch.stack([x[0] ** 2 + x[1] ** 2 - 5.0,
                                          x[0] * x[1] - 2.0]),
                [0.9, 2.2], None, (2, 2),
                {"real_only": True, "all_roots": False}),
    "parametrized": (lambda x, p: jnp.array([x[0] ** 2 - p]),
                     lambda x, p: torch.stack([x[0] ** 2 - p]),
                     [1.0], 9.0, (2,), {"real_only": True}),
}


@pytest.mark.parametrize("case", sorted(POLY_CASES))
def test_solve_polynomial_matches_jax(case):
    jf, tf, u0, p, degrees, kw = POLY_CASES[case]
    jsol = jph.solve_polynomial(jnls.NonlinearProblem(jf, jnp.array(u0), p),
                                jph.PolynomialHomotopy(degrees=degrees),
                                **kw)
    tsol = tph.solve_polynomial(tnls.NonlinearProblem(tf, _t(u0), p),
                                tph.PolynomialHomotopy(degrees=degrees),
                                **kw)
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    np.testing.assert_allclose(_sorted_rows(tsol.u.numpy()),
                               _sorted_rows(jsol.u), atol=1e-8)
    (je, jok), (te, tok) = jsol.original, tsol.original
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0,
                               atol=1e-12)
    assert tsol.counters["host_syncs"] >= tsol.counters["loop_steps"] > 0
    if case == "cubic":
        np.testing.assert_allclose(
            np.sort_complex(tsol.u.numpy().ravel()),
            np.sort_complex(np.exp(2j * np.pi * np.arange(3) / 3)),
            atol=1e-8)
    if case == "nearest":
        np.testing.assert_allclose(tsol.u.numpy(), [1.0, 2.0], atol=1e-8)
        assert tsol.resid.shape == (2,)


def test_lockstep_batch_equals_lone_tracks():
    """Each path of the batch is its lone track (success flag and step
    count equal, the endpoint within 1e-12), though the rows stop at other
    steps.  On the CPU torch's vectorised complex ``pow`` and ``abs`` round
    otherwise than their scalar tail, so a row of a batch parts from its
    lone track at the ulp level; on the card the two are equal bit for bit
    (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 25)."""
    alg = tph.PolynomialHomotopy(degrees=(2, 3), dt_initial=0.5)

    def f(x):
        return torch.stack([x[0] ** 2 + 3 * x[0] * x[1] - 1.0,
                            x[1] ** 3 - 4 * x[0] + 0.5])
    starts = tph._start_roots(alg.degrees, torch.complex128)
    x, ok, steps = tph._track_paths(f, alg.degrees, alg, torch.complex128)
    assert len(set(steps.tolist())) > 1
    for i in (0, 1, 5):          # the 20-step row and two 17-step rows
        xi, oki, si = tph._track_paths(f, alg.degrees, alg, torch.complex128,
                                       starts=starts[i:i + 1])
        assert bool(oki[0]) == bool(ok[i]) and int(si[0]) == int(steps[i])
        torch.testing.assert_close(xi[0], x[i], rtol=1e-12, atol=0)


def test_f32_tracks_in_complex64():
    tsol = tph.solve_polynomial(
        tnls.NonlinearProblem(lambda x, p: torch.stack([x[0] ** 2 - 4.0]),
                              _t([1.0], torch.float32)),
        tph.PolynomialHomotopy(degrees=(2,), corrector_tol=1e-5),
        real_only=True)
    assert tsol.original[0].dtype == torch.complex64
    assert tsol.u.dtype == torch.float32
    np.testing.assert_allclose(np.sort(tsol.u.numpy().ravel()), [-2, 2],
                               atol=1e-5)


def test_wilkinson6_multi_gamma_recovers_all():
    prob = tnls.NonlinearProblem(
        lambda x, p: torch.stack([(x[0] - 1) * (x[0] - 2) * (x[0] - 3)
                                  * (x[0] - 4) * (x[0] - 5) * (x[0] - 6)]),
        _t([0.0]))
    sol = tph.solve_polynomial(prob, tph.PolynomialHomotopy(
        degrees=(6,), dt_initial=0.01), real_only=True)
    np.testing.assert_allclose(np.sort(sol.u.numpy().ravel()),
                               [1, 2, 3, 4, 5, 6], atol=1e-6)


# ---------------------------------------------------------------------------
@pytest.mark.parametrize("entry", ["solve_polynomial",
                                   "HomotopyContinuationJL",
                                   "solve_multistart"])
def test_python_number_u0_tracks_in_complex128(entry):
    """A Python number or list ``u0`` is f64, as under x64 JAX: the paths
    run in complex128 and the roots come back in f64 on the device of the
    tensor ``p`` (on the card when nothing is a tensor,
    ``tests/test_torch_cuda.py``), the JAX package's within 1e-12."""
    p = _t(9.0)
    if entry == "solve_polynomial":
        jsol = jph.solve_polynomial(
            jnls.NonlinearProblem(lambda x, q: jnp.array([x[0] ** 2 - q]),
                                  [1.0], 9.0),
            jph.PolynomialHomotopy(degrees=(2,)), real_only=True)
        tsol = tph.solve_polynomial(
            tnls.NonlinearProblem(lambda x, q: torch.stack([x[0] ** 2 - q]),
                                  [1.0], p),
            tph.PolynomialHomotopy(degrees=(2,)), real_only=True)
        assert tsol.original[0].dtype == torch.complex128
        np.testing.assert_allclose(tsol.original[0].numpy(),
                                   np.asarray(jsol.original[0]), rtol=0,
                                   atol=1e-12)
        troots, jroots = tsol.u, jsol.u
    elif entry == "HomotopyContinuationJL":
        kw = {"all_roots": True}
        jsol = jnls.solve(jnls.NonlinearProblem(
            lambda u, q: u ** 2 - 6 * u + q, 0.0, 9.0 - 1.0),
            jnls.HomotopyContinuationJL(**kw))
        tsol = tnls.solve(tnls.NonlinearProblem(
            lambda u, q: u ** 2 - 6 * u + q, 0.0, p - 1.0),
            tnls.HomotopyContinuationJL(**kw))
        assert int(tsol.retcode) == int(jsol.retcode) == 1
        assert tsol.u.shape == jsol.u.shape
        troots, jroots = tsol.u, jsol.u
    else:
        troots = tnls.solve_multistart(tnls.NonlinearProblem(
            lambda u, q: torch.sin(u) - 0.0 * q, [1.0], p), order=3)
        jroots = jnls.solve_multistart(jnls.NonlinearProblem(
            lambda u, q: jnp.sin(u) - 0.0 * q, [1.0], 9.0), order=3)
        np.testing.assert_allclose(np.sort(troots.numpy().ravel()),
                                   [0.0, np.pi], atol=1e-12)
    assert troots.dtype == F64 and troots.device == p.device
    np.testing.assert_allclose(_sorted_rows(troots.numpy()),
                               _sorted_rows(jroots), rtol=0, atol=1e-12)


# HomotopyContinuationJL
# ---------------------------------------------------------------------------

def _quad(m):
    return lambda u, p: u ** 2 - 5 * u + 6


HC_CASES = {
    "all_roots_quadratic": (
        lambda m: _quad(m), [0.0], {"all_roots": True}),
    "nearest_root_0": (lambda m: _quad(m), [0.0], {}),
    "nearest_root_5": (lambda m: _quad(m), [5.0], {}),
    "explicit_degrees_system": (
        lambda m: (lambda u, p: m.stack([u[0] ** 2 + u[1] ** 2 - 5.0,
                                         u[0] * u[1] - 2.0])),
        [1.0, 1.0], {"all_roots": True, "degrees": (2, 2)}),
    "denominator_filter": (
        lambda m: m.hf(f=lambda u, p: u ** 2 - 4 * u + 3.0,
                       denominator=lambda u, p: u - 3.0),
        [0.0], {"all_roots": True}),
    "all_filtered_infeasible": (
        lambda m: m.hf(f=lambda u, p: u ** 2 - 7 * u + 10.0,
                       denominator=lambda u, p: (u - 2.0) * (u - 5.0)),
        [0.0], {"all_roots": True}),
    "unpolynomialize_branches": (
        lambda m: m.hf(f=lambda v, p: v - 4.0,
                       polynomialize=lambda u, p: u ** 2,
                       unpolynomialize=lambda v, p: [m.sqrt(v),
                                                     -m.sqrt(v)]),
        [1.0], {"all_roots": True}),
    "unpolynomialize_nearest": (
        lambda m: m.hf(f=lambda v, p: v - 4.0,
                       polynomialize=lambda u, p: u ** 2,
                       unpolynomialize=lambda v, p: [m.sqrt(v),
                                                     -m.sqrt(v)]),
        [1.0], {}),
}


class _J:
    stack, sqrt = staticmethod(jnp.stack), staticmethod(jnp.sqrt)
    hf = staticmethod(jnls.HomotopyNonlinearFunction)
    asarray = staticmethod(jnp.array)


class _T:
    stack, sqrt = staticmethod(torch.stack), staticmethod(torch.sqrt)
    hf = staticmethod(tnls.HomotopyNonlinearFunction)
    asarray = staticmethod(_t)


@pytest.mark.parametrize("case", sorted(HC_CASES))
def test_homotopy_continuation_matches_jax(case):
    make_f, u0, kw = HC_CASES[case]
    jsol = jnls.solve(jnls.NonlinearProblem(make_f(_J), jnp.array(u0)),
                      jnls.HomotopyContinuationJL(**kw))
    tsol = tnls.solve(tnls.NonlinearProblem(make_f(_T), _t(u0)),
                      tnls.HomotopyContinuationJL(**kw))
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    if int(jsol.retcode) != 1:
        assert int(tsol.retcode) == int(tnls.ReturnCode.Infeasible)
        return
    np.testing.assert_allclose(_sorted_rows(tsol.u.numpy()),
                               _sorted_rows(jsol.u), atol=1e-8)
    np.testing.assert_allclose(tsol.resid.numpy(), np.asarray(jsol.resid),
                               atol=1e-8)


def test_degree_measurement():
    f = lambda x: np.array([x[0] ** 3 - x[1], x[0] * x[1] - 1.0])  # noqa
    assert t_measure(f, 2) == j_measure(f, 2) == (3, 2)
    with pytest.raises(ValueError, match="not polynomial"):
        t_measure(lambda x: np.array([np.sin(x[0])]), 1)


@pytest.mark.parametrize("all_roots", [True, False])
def test_taylor_variant_matches_jax(all_roots):
    jsol = jnls.solve(jnls.NonlinearProblem(lambda u, p: jnp.sin(u) - 0.5,
                                            jnp.array([0.3])),
                      jnls.TaylorHomotopyContinuationJL(
                          degree=3, all_roots=all_roots))
    tsol = tnls.solve(tnls.NonlinearProblem(lambda u, p: torch.sin(u) - 0.5,
                                            _t([0.3])),
                      tnls.TaylorHomotopyContinuationJL(
                          degree=3, all_roots=all_roots))
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    np.testing.assert_allclose(_sorted_rows(tsol.u.numpy()),
                               _sorted_rows(jsol.u), atol=1e-8)
    np.testing.assert_allclose(np.sin(tsol.u.numpy()), 0.5, atol=1e-10)
    if not all_roots:
        np.testing.assert_allclose(tsol.u.numpy(), [np.pi / 6], atol=1e-8)


# ---------------------------------------------------------------------------
# multistart (the JAX tests' own assertions)
# ---------------------------------------------------------------------------

def test_multistart_scalar_sin():
    roots = tnls.solve_multistart(tnls.NonlinearProblem(
        lambda u, p: torch.sin(u), _t([1.0]), None), order=3)
    np.testing.assert_allclose(np.sort(roots.numpy().ravel()),
                               [0.0, np.pi], atol=1e-9)


def test_multistart_polynomial_system_all_roots():
    def f2(u, p):
        return torch.stack([u[0] ** 2 + u[1] ** 2 - 4.0, u[0] * u[1] - 1.0])
    roots = tnls.solve_multistart(tnls.NonlinearProblem(f2, _t([1.0, 1.0])),
                                  order=2).numpy()
    assert roots.shape[0] == 4
    for r in roots:
        assert abs(r[0] ** 2 + r[1] ** 2 - 4) < 1e-8
        assert abs(r[0] * r[1] - 1) < 1e-8


def test_multistart_transcendental_equilibria():
    def f3(u, p):
        return torch.stack([u[0] - u[0] ** 3 - 0.2 * u[1],
                            u[1] - torch.tanh(u[0])])
    roots = tnls.solve_multistart(tnls.NonlinearProblem(f3, _t([0.5, 0.5])),
                                  order=3)
    assert roots.shape[0] == 3   # +/- branch and the origin
    for r in roots:
        assert float(f3(r, None).abs().max()) < 1e-8


def test_polynomialize_exactness_and_jax_model():
    """A degree-2 residual is its order-2 model; the order-3 model of a
    smooth residual is the JAX package's at sample points."""
    def f(u, p):
        return torch.stack([u[0] ** 2 - u[1], u[0] + u[1] ** 2 - 3.0])
    poly_f, degrees = tnls.polynomialize(f, _t([0.3, -0.7]), None, order=2)
    assert degrees == (2, 2)
    for pt in [[1.0, 2.0], [-3.0, 0.5]]:
        np.testing.assert_allclose(poly_f(_t(pt)).numpy(),
                                   f(_t(pt), None).numpy(), atol=1e-10)
    jpoly, jdeg = jnls.polynomialize(
        lambda u, p: jnp.array([jnp.sin(u[0]) * u[1], jnp.exp(u[1])]),
        jnp.array([0.2, 0.1]), None, order=3)
    tpoly, tdeg = tnls.polynomialize(
        lambda u, p: torch.stack([torch.sin(u[0]) * u[1], torch.exp(u[1])]),
        _t([0.2, 0.1]), None, order=3)
    assert tdeg == jdeg
    for pt in [[0.5, -0.3], [1.0 + 0.5j, 0.2j]]:
        dt = torch.complex128 if isinstance(pt[0], complex) else F64
        np.testing.assert_allclose(tpoly(torch.tensor(pt, dtype=dt)).numpy(),
                                   np.asarray(jpoly(jnp.asarray(pt))),
                                   rtol=1e-13)

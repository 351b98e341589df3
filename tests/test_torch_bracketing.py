"""The bracketing tier against the JAX package: every test of
``tests/test_bracketing.py`` in both packages on the same inputs, f64 on
the CPU (the JAX package with x64, as ``tests/conftest.py`` sets it).

Each solve must give the JAX package's retcode, ``nsteps`` and ``nf``, and
a root within 4 ulps of its (``ULPS``); derivatives within rel 1e-8 of
both the JAX package's and the exact ones (``GRAD_RTOL``, the JAX test's
bound).

The residuals are written as XLA evaluates the JAX ones.  In seven of
the methods' steps XLA contracts ``u * u - p`` into one fused
multiply-add (one rounding), so the port's side is ``torch.addcmul(-p,
u, u)`` there; with two roundings Falsi and Brent on u² − 2 take other
paths at the ulp level (Falsi ends in FloatingPointLimit after 22 steps
against 24, Brent succeeds in 8 against 10, the roots 733 ulps apart,
both below abstol).  In ModAB's step XLA keeps two roundings (its f at
0.52833… for p = 0.3 is −0.020863888888888904, the fused value
−0.02086388888888889), so ModAB's port side is ``u * u - p``
(``_port_square``).  Measured over p in {1, 4, 9, 16, 2.5, 0.3, 2, 0.7,
5.5, 3.3} and brackets (0, 10), (1, 2), (0.1, 5): with these residuals
every method gives the JAX package's retcode and nf on every row, except
ModAB at (0, 10) with p = 3.3 and at (0.1, 5) with p = 2.5, where XLA
contracts some of ModAB's evaluations and not others; no test here uses
those two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.solvers import bracketing as jbrk
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.solvers import bracketing as tbrk

torch.set_num_threads(1)

NAMES = ["Bisection", "Falsi", "Ridder", "Brent", "ITP", "Alefeld", "Muller",
         "ModAB"]
ULPS = 4
GRAD_RTOL = 1e-8
F64 = torch.float64


def _t(x):
    return torch.tensor(x, dtype=F64)


def _ulps(a, b):
    a, b = np.float64(a), np.float64(b)
    return abs(int(a.view(np.int64)) - int(b.view(np.int64)))


def _same(jsol, tsol):
    """The JAX package's retcode, nsteps and nf, and a root within ULPS."""
    assert (int(tsol.retcode), tsol.stats.nsteps, tsol.stats.nf) == \
        (int(jsol.retcode), int(jsol.stats.nsteps), int(jsol.stats.nf))
    assert _ulps(float(jsol.u), float(tsol.u)) <= ULPS, \
        (float(jsol.u), float(tsol.u))


def _pair(name, jf, tf, tspan, p=None, tp=None):
    jsol = jnls.solve(jnls.IntervalNonlinearProblem(jf, tspan, p),
                      getattr(jbrk, name)())
    tsol = tnls.solve(tnls.IntervalNonlinearProblem(
        tf, tuple(_t(x) for x in tspan), tp), getattr(tbrk, name)())
    return jsol, tsol


def _sq(u, p):
    return u * u - p


def _tsq(u, p):
    return torch.addcmul(-p, u, u)


def _port_square(name):
    """u² − p as XLA rounds it in ``name``'s step (module docstring)."""
    return _sq if name in ("ModAB", None) else _tsq


@pytest.mark.parametrize("name", NAMES)
def test_sqrt2(name):
    jsol, tsol = _pair(name, _sq, _port_square(name), (1.0, 2.0), 2.0,
                       _t(2.0))
    _same(jsol, tsol)
    assert bool(tsol.success), int(tsol.retcode)
    np.testing.assert_allclose(float(tsol.u), np.sqrt(2.0), atol=1e-8)


@pytest.mark.parametrize("name", NAMES)
def test_cosine(name):
    jsol, tsol = _pair(name, lambda u, p: jnp.cos(u),
                       lambda u, p: torch.cos(u), (1.0, 2.0))
    _same(jsol, tsol)
    assert bool(tsol.success)
    np.testing.assert_allclose(float(tsol.u), np.pi / 2, atol=1e-8)


def test_default_is_modab():
    jsol = jnls.solve(jnls.IntervalNonlinearProblem(
        lambda u, p: u ** 3 - 2.0, (0.0, 2.0)))
    tsol = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, p: u ** 3 - 2.0, (_t(0.0), _t(2.0))))
    _same(jsol, tsol)
    assert bool(tsol.success)
    np.testing.assert_allclose(float(tsol.u), 2 ** (1 / 3), atol=1e-8)
    # ModAB() given is the default
    again = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, p: u ** 3 - 2.0, (_t(0.0), _t(2.0))), tnls.ModAB())
    assert float(again.u) == float(tsol.u)


@pytest.mark.parametrize("name", NAMES)
def test_exact_endpoints(name):
    jsol, tsol = _pair(name, lambda u, p: u, lambda u, p: u, (0.0, 2.0))
    _same(jsol, tsol)
    assert tsol.retcode == tnls.ReturnCode.ExactSolutionLeft
    assert float(tsol.u) == 0.0
    jsol, tsol = _pair(name, lambda u, p: u - 2.0, lambda u, p: u - 2.0,
                       (0.0, 2.0))
    _same(jsol, tsol)
    assert tsol.retcode == tnls.ReturnCode.ExactSolutionRight


@pytest.mark.parametrize("name", NAMES)
def test_non_enclosing_interval(name):
    jsol, tsol = _pair(name, lambda u, p: u * u + 1.0,
                       lambda u, p: u * u + 1.0, (0.0, 1.0))
    _same(jsol, tsol)
    if name == "Muller":          # needs no bracket: runs to maxiters
        assert tsol.retcode == tnls.ReturnCode.MaxIters
    else:
        assert tsol.retcode == tnls.ReturnCode.InitialFailure
    assert not bool(tsol.success)


@pytest.mark.parametrize("name", [n for n in NAMES if n != "Muller"])
def test_flipped_interval(name):
    jsol, tsol = _pair(name, _sq, _port_square(name), (2.0, 1.0), 2.0,
                       _t(2.0))
    _same(jsol, tsol)
    assert bool(tsol.success)
    np.testing.assert_allclose(float(tsol.u), np.sqrt(2.0), atol=1e-8)


@pytest.mark.parametrize("name", NAMES)
def test_batched_bracketing(name):
    """The JAX test vmaps ITP over p; here the batch is 1-d tensors, every
    row equal to its lone solve in both packages (the JAX package's
    vmapped solve and its lone solves alike)."""
    ps = np.array([1.0, 4.0, 9.0, 16.0, 2.5, 0.3])
    alg = getattr(jbrk, name)()

    def jone(p):
        return jnls.solve(jnls.IntervalNonlinearProblem(_sq, (0.0, 10.0), p),
                          alg)

    jv = jax.vmap(lambda p: (lambda s: (s.u, s.retcode, s.stats.nf,
                                        s.stats.nsteps))(jone(p)))(
        jnp.asarray(ps))
    tf = _port_square(name)
    tsol = tnls.solve(tnls.IntervalNonlinearProblem(
        tf, (_t(0.0), _t(10.0)), _t(ps)), getattr(tbrk, name)())
    assert tsol.u.shape == tsol.retcode.shape == (len(ps),)
    assert tsol.retcode.dtype == torch.int32
    np.testing.assert_array_equal(tsol.retcode.numpy(), np.asarray(jv[1]))
    np.testing.assert_array_equal(tsol.stats.nf.numpy(), np.asarray(jv[2]))
    np.testing.assert_array_equal(tsol.stats.nsteps.numpy(),
                                  np.asarray(jv[3]))
    for k, p in enumerate(ps):
        assert _ulps(float(jv[0][k]), float(tsol.u[k])) <= ULPS
        lone = tnls.solve(tnls.IntervalNonlinearProblem(
            tf, (_t(0.0), _t(10.0)), _t(p)), getattr(tbrk, name)())
        assert float(lone.u) == float(tsol.u[k])
        assert (int(lone.retcode), lone.stats.nf, lone.stats.nsteps) == (
            int(tsol.retcode[k]), int(tsol.stats.nf[k]),
            int(tsol.stats.nsteps[k]))
    if name not in ("Muller",):
        np.testing.assert_allclose(tsol.u.numpy(), np.sqrt(ps), atol=1e-8)
        assert bool(tsol.success.all())
    left, right = tsol.original
    assert left.shape == right.shape == (len(ps),)


def test_batched_endpoints_and_shared_p():
    """Batched endpoints with a shared p; the bracket (original) as the
    JAX package returns it."""
    lefts, rights = np.array([0.5, 1.0, 1.2]), np.array([3.0, 2.0, 1.9])
    jv = jax.vmap(lambda l, r: (lambda s: (s.u, s.original[0],
                                           s.original[1]))(jnls.solve(
        jnls.IntervalNonlinearProblem(_sq, (l, r), 2.0), jnls.Brent())))(
        jnp.asarray(lefts), jnp.asarray(rights))
    tsol = tnls.solve(tnls.IntervalNonlinearProblem(
        _tsq, (_t(lefts), _t(rights)), _t(2.0)), tnls.Brent())
    for k in range(3):
        assert _ulps(float(jv[0][k]), float(tsol.u[k])) <= ULPS
        assert float(tsol.original[0][k]) == float(jv[1][k])
        assert float(tsol.original[1][k]) == float(jv[2][k])


@pytest.mark.parametrize("name", ["ITP", "Bisection", "Brent", None])
def test_gradients_through_bracketing(name):
    """The implicit-function derivative du/dp = 1/(2√p), against the JAX
    package's custom JVP and the exact value."""
    def jroot(p):
        alg = None if name is None else getattr(jbrk, name)()
        return jnls.solve(jnls.IntervalNonlinearProblem(
            lambda u, q: u ** 2 - q, (0.1, 5.0), p), alg).u

    jg = float(jax.grad(jroot)(2.0))
    p = _t(2.0).requires_grad_(True)
    alg = None if name is None else getattr(tbrk, name)()
    u = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, q: u ** 2 - q, (_t(0.1), _t(5.0)), p), alg).u
    g, = torch.autograd.grad(u, p)
    expected = 1 / (2 * np.sqrt(2))
    np.testing.assert_allclose(float(g), expected, rtol=GRAD_RTOL)
    np.testing.assert_allclose(float(g), jg, rtol=GRAD_RTOL)


def test_second_derivative_through_bracketing():
    """grad(grad(root)): the backward rebuilds u(p) through the same
    function, so its own derivative is the derivative of the root."""
    def jroot(p):
        return jnls.solve(jnls.IntervalNonlinearProblem(
            lambda u, q: u ** 2 - q, (0.1, 5.0), p)).u

    jh = float(jax.grad(jax.grad(jroot))(2.0))
    p = _t(2.0).requires_grad_(True)
    u = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, q: u ** 2 - q, (_t(0.1), _t(5.0)), p)).u
    g, = torch.autograd.grad(u, p, create_graph=True)
    h, = torch.autograd.grad(g, p)
    expected = -1 / (4 * 2 ** 1.5)
    np.testing.assert_allclose(float(h), expected, rtol=GRAD_RTOL)
    np.testing.assert_allclose(float(h), jh, rtol=GRAD_RTOL)


def test_batched_gradient():
    """du_i/dp_i of a batch (one p a row), and the sum over rows for a p
    that all rows share."""
    ps = _t([0.5, 2.0, 7.0]).requires_grad_(True)
    u = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, q: u ** 2 - q, (_t(0.1), _t(5.0)), ps), tnls.ITP()).u
    g, = torch.autograd.grad(u.sum(), ps)
    np.testing.assert_allclose(g.detach().numpy(),
                               1 / (2 * np.sqrt([0.5, 2.0, 7.0])),
                               rtol=GRAD_RTOL)
    q = _t(3.0).requires_grad_(True)
    u = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, q: u ** 2 - q, (_t([0.1, 0.2]), _t([5.0, 4.0])), q)).u
    g, = torch.autograd.grad(u.sum(), q)
    np.testing.assert_allclose(float(g), 2 / (2 * np.sqrt(3.0)),
                               rtol=GRAD_RTOL)


def test_dtype_and_device_policy(monkeypatch):
    """Python-float endpoints are f64 (``result_type`` under x64); a
    tensor keeps its dtype with f32 as the floor; with no tensor at all
    the solve runs on the card, and raises without CUDA."""
    sol = tnls.solve(tnls.IntervalNonlinearProblem(
        _tsq, (torch.tensor(1.0, dtype=torch.float32), 2.0), _t(2.0)))
    assert sol.u.dtype == torch.float64
    sol = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, p: u * u - 2.0, (torch.tensor(1.0, dtype=torch.float16),
                                   torch.tensor(2.0, dtype=torch.float16))))
    assert sol.u.dtype == torch.float32
    jsol = jnls.solve(jnls.IntervalNonlinearProblem(
        _sq, (jnp.float32(1.0), jnp.float32(2.0)), 2.0))
    tsol = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, p: torch.addcmul(torch.tensor(-p, dtype=u.dtype), u, u),
        (torch.tensor(1.0, dtype=torch.float32),
         torch.tensor(2.0, dtype=torch.float32)), 2.0))
    assert jsol.u.dtype == jnp.float32 and tsol.u.dtype == torch.float32
    _same(jsol, tsol)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnls.solve(tnls.IntervalNonlinearProblem(_sq, (1.0, 2.0), 2.0))


def test_options():
    prob = tnls.IntervalNonlinearProblem(_tsq, (_t(1.0), _t(2.0)), _t(2.0))
    # verbose runs since ROADMAP A.18 (its message: test_torch_interfaces)
    assert tnls.solve(prob, tnls.Bisection(), verbose=True).success
    with pytest.raises(ValueError, match="bracketing"):
        tnls.solve(prob, tnls.NewtonRaphson())
    sol = tnls.solve(prob, tnls.Bisection(), maxiters=3)
    assert sol.retcode == tnls.ReturnCode.MaxIters
    assert sol.stats.nsteps == 3
    # a lone solve reads its retcode and counts once, with one flag a step
    _backend.reset_counters()
    sol = tnls.solve(prob, tnls.Bisection())
    assert sol.counters["host_syncs"] == sol.stats.nsteps + 2

"""Differentiating through ``solve`` against the JAX package: every case of
``tests/test_sensitivities_bounds.py`` (IFT sensitivities, bounds, pre-
and postconditioning) and the second derivative of
``tests/test_bracketing.py`` (its lines 79-92), in both packages on the
same inputs, f64 on the CPU.

Reverse mode is ``torch.autograd.grad`` and forward mode
``torch.autograd.forward_ad``; the JAX side is ``jax.grad`` / ``jax.jacfwd``
/ ``jax.jacrev``.  Tolerances: the dense branch of the implicit-function
rule within rel 1e-10 of the JAX package (``DENSE_RTOL``); the Krylov
(GMRES) and MINRES branches, reached by lowering ``_DENSE_IFT_LIMIT`` in
both packages (the ``limit`` fixture), within rel 1e-8 (``KRYLOV_RTOL``);
second derivatives within 1e-12 (``HESS_ATOL``).  The JAX tests' own bounds
against the exact values hold too.

``test_vmap_of_grad`` becomes three lone gradients: ``torch.func.vmap``
cannot map the engines' host reads (ROADMAP C).  The SCC case of
``test_gradients_through_dfsane_anderson_scc`` is in
``test_torch_homotopy_sensitivity.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad as fwAD

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.core import sensitivity as jsens
from nonlinearsolve_tpu.core.conditioning import \
    PostconditionSpecifier as JPost
from nonlinearsolve_tpu_torch.core import sensitivity as tsens
from nonlinearsolve_tpu_torch.core.conditioning import \
    PostconditionSpecifier as TPost

torch.set_num_threads(2)

DENSE_RTOL = 1e-10
KRYLOV_RTOL = 1e-8
HESS_ATOL = 1e-12
EXACT = 1 / (2 * np.sqrt(2.0))


@pytest.fixture(autouse=True)
def _clear_jax_caches():
    yield
    jax.clear_caches()


@pytest.fixture
def limit(monkeypatch):
    """Lower ``_DENSE_IFT_LIMIT`` in both packages (the Krylov branches at
    small n)."""
    def set_limit(n):
        monkeypatch.setattr(jsens, "_DENSE_IFT_LIMIT", n)
        monkeypatch.setattr(tsens, "_DENSE_IFT_LIMIT", n)
    return set_limit


def _t(x):
    return torch.tensor(x, dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _alg(m, name):
    return None if name is None else getattr(m, name)()


def jsqrt_root(name="NewtonRaphson"):
    def g(p):
        prob = jnls.NonlinearProblem(lambda u, q: u * u - q,
                                     jnp.array([1.0]), p)
        return jnls.solve(prob, _alg(jnls, name)).u[0]
    return g


def tsqrt_root(name="NewtonRaphson"):
    def g(p):
        prob = tnls.NonlinearProblem(lambda u, q: u * u - q, _t([1.0]), p)
        return tnls.solve(prob, _alg(tnls, name)).u[0]
    return g


def tgrad(fn, p):
    p = _t(p).requires_grad_(True)
    return float(torch.autograd.grad(fn(p), p)[0])


def tjvp(fn, p, tangent=1.0):
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(_t(p), _t(tangent)))
        return fwAD.unpack_dual(out).tangent


def test_forward_sensitivity():
    jg = float(jax.jacfwd(jsqrt_root())(2.0))
    tg = float(tjvp(tsqrt_root(), 2.0))
    assert _rel(tg, jg) <= DENSE_RTOL
    np.testing.assert_allclose(tg, EXACT, rtol=1e-10)


def test_reverse_sensitivity():
    jg = float(jax.grad(jsqrt_root())(2.0))
    tg = tgrad(tsqrt_root(), 2.0)
    assert _rel(tg, jg) <= DENSE_RTOL
    np.testing.assert_allclose(tg, EXACT, rtol=1e-10)


@pytest.mark.parametrize("name", ["TrustRegion", "Broyden", "DFSane", None],
                         ids=["TR", "Broyden", "DFSane", "polyalg"])
def test_sensitivity_algorithm_independent(name):
    """The rule needs only the root: the gradient of each solver's root
    is the JAX package's for the same solver."""
    jg = float(jax.grad(jsqrt_root(name))(2.0))
    tg = tgrad(tsqrt_root(name), 2.0)
    assert _rel(tg, jg) <= DENSE_RTOL
    np.testing.assert_allclose(tg, EXACT, rtol=1e-7)


def test_pytree_parameter_gradient():
    """A dict ``p``: the Function takes the leaves that require grad."""
    def jg(p):
        prob = jnls.NonlinearProblem(
            lambda u, q: u ** 3 - q["a"] * u - q["b"], jnp.array([2.0]), p)
        return jnls.solve(prob, jnls.NewtonRaphson()).u[0]

    jgot = jax.grad(jg)({"a": 1.0, "b": 2.0})
    p = {"a": _t(1.0).requires_grad_(True), "b": _t(2.0).requires_grad_(True)}
    prob = tnls.NonlinearProblem(
        lambda u, q: u ** 3 - q["a"] * u - q["b"], _t([2.0]), p)
    u = tnls.solve(prob, tnls.NewtonRaphson()).u[0]
    ga, gb = torch.autograd.grad(u, [p["a"], p["b"]])
    assert _rel(float(ga), float(jgot["a"])) <= DENSE_RTOL
    assert _rel(float(gb), float(jgot["b"])) <= DENSE_RTOL
    denom = 3 * float(u.detach()) ** 2 - 1.0
    np.testing.assert_allclose(float(ga), float(u.detach()) / denom,
                               rtol=1e-8)
    np.testing.assert_allclose(float(gb), 1 / denom, rtol=1e-8)
    # a tuple p with one leaf that requires grad and one that does not
    q = (_t(1.0), _t(2.0).requires_grad_(True))
    prob = tnls.NonlinearProblem(lambda u, q: u ** 3 - q[0] * u - q[1],
                                 _t([2.0]), q)
    g, = torch.autograd.grad(tnls.solve(prob, tnls.NewtonRaphson()).u[0],
                             q[1])
    assert _rel(float(g), float(jgot["b"])) <= DENSE_RTOL


def test_vmap_of_grad():
    """The JAX test's ``vmap(grad)`` over p = 1, 4, 9, as three lone
    gradients."""
    jgot = np.asarray(jax.vmap(jax.grad(jsqrt_root()))(
        jnp.array([1.0, 4.0, 9.0])))
    tgot = np.array([tgrad(tsqrt_root(), p) for p in (1.0, 4.0, 9.0)])
    assert _rel(tgot, jgot) <= DENSE_RTOL
    np.testing.assert_allclose(tgot, 1 / (2 * np.sqrt([1.0, 4.0, 9.0])),
                               rtol=1e-8)


def test_second_derivative():
    """grad(grad) through the dense branch: the backward rebuilds u(p)
    through the same Function and computes with graph."""
    jh = float(jax.grad(jax.grad(jsqrt_root()))(2.0))
    p = _t(2.0).requires_grad_(True)
    g, = torch.autograd.grad(tsqrt_root()(p), p, create_graph=True)
    h, = torch.autograd.grad(g, p)
    assert abs(float(h) - jh) <= HESS_ATOL
    np.testing.assert_allclose(float(h), -1 / (4 * 2 ** 1.5), rtol=1e-10)


def test_second_derivative_through_bracketing():
    """``tests/test_bracketing.py``'s hessian of the bracketing root."""
    def jroot(p):
        return jnls.solve(jnls.IntervalNonlinearProblem(
            lambda u, q: u ** 2 - q, (0.1, 5.0), p)).u

    jh = float(jax.grad(jax.grad(jroot))(2.0))
    p = _t(2.0).requires_grad_(True)
    u = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, q: u ** 2 - q, (_t(0.1), _t(5.0)), p)).u
    g, = torch.autograd.grad(u, p, create_graph=True)
    h, = torch.autograd.grad(g, p)
    assert abs(float(h) - jh) <= HESS_ATOL
    np.testing.assert_allclose(float(h), -1 / (4 * 2 ** 1.5), rtol=1e-8)


def _vec_problem(m):
    """u ∘ u + 0.1 tanh(u) = p on n = 6 unknowns: a coupled diagonal
    system with a closed-form Jacobian."""
    def f(u, p):
        return u * u + 0.1 * m.tanh(u) - p
    return f


P6 = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
W6 = np.array([0.3, -1.2, 0.7, 2.0, -0.4, 1.1])


def test_krylov_branch(limit):
    """n = 6 above a limit of 4: GMRES on the residual's jvp, its
    transpose on the vjp (reverse), the forward solve (forward mode)."""
    limit(4)

    def jloss(p):
        prob = jnls.NonlinearProblem(_vec_problem(jnp), jnp.ones(6), p)
        return jnp.dot(jnp.asarray(W6), jnls.solve(
            prob, jnls.NewtonRaphson(), abstol=1e-12).u)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(P6)))
    p = _t(P6).requires_grad_(True)
    prob = tnls.NonlinearProblem(_vec_problem(torch), torch.ones(
        6, dtype=torch.float64), p)
    u = tnls.solve(prob, tnls.NewtonRaphson(), abstol=1e-12).u
    tg, = torch.autograd.grad((_t(W6) * u).sum(), p)
    assert tsens.STATS["branch"] == "gmres" and tsens.STATS["transpose"]
    assert _rel(tg.numpy(), jg) <= KRYLOV_RTOL
    # forward mode along e_2 against jacfwd's column
    jcol = np.asarray(jax.jacfwd(lambda p: jnls.solve(
        jnls.NonlinearProblem(_vec_problem(jnp), jnp.ones(6), p),
        jnls.NewtonRaphson(), abstol=1e-12).u)(jnp.asarray(P6)))[:, 2]
    with fwAD.dual_level():
        pd = fwAD.make_dual(_t(P6), _t(np.eye(6)[2]))
        ud = tnls.solve(tnls.NonlinearProblem(
            _vec_problem(torch), torch.ones(6, dtype=torch.float64), pd),
            tnls.NewtonRaphson(), abstol=1e-12).u
        tcol = fwAD.unpack_dual(ud).tangent
    assert tsens.STATS["branch"] == "gmres" and not tsens.STATS["transpose"]
    assert _rel(tcol.numpy(), jcol) <= KRYLOV_RTOL


def test_krylov_branch_second_derivative(limit):
    """grad(grad) on the GMRES branch: the solve's own derivative (the
    JAX package's custom_linear_solve)."""
    limit(4)

    def jloss(p):
        prob = jnls.NonlinearProblem(_vec_problem(jnp), jnp.ones(6), p)
        return jnp.dot(jnp.asarray(W6), jnls.solve(
            prob, jnls.NewtonRaphson(), abstol=1e-12).u)

    jh = np.asarray(jax.grad(lambda p: jnp.sum(jax.grad(jloss)(p)))(
        jnp.asarray(P6)))
    p = _t(P6).requires_grad_(True)
    u = tnls.solve(tnls.NonlinearProblem(
        _vec_problem(torch), torch.ones(6, dtype=torch.float64), p),
        tnls.NewtonRaphson(), abstol=1e-12).u
    g, = torch.autograd.grad((_t(W6) * u).sum(), p, create_graph=True)
    h, = torch.autograd.grad(g.sum(), p)
    assert _rel(h.detach().numpy(), jh) <= KRYLOV_RTOL


def test_bounds_two_sided():
    jsol = jnls.solve(jnls.NonlinearProblem(
        lambda u, p: u * u - p, jnp.array([-1.0]), 2.0, lb=-2.0, ub=0.0),
        jnls.NewtonRaphson())
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: u * u - p, _t([-1.0]), 2.0, lb=-2.0, ub=0.0),
        tnls.NewtonRaphson())
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    assert _rel(tsol.u.numpy(), np.asarray(jsol.u)) <= 1e-12
    np.testing.assert_allclose(float(tsol.u[0]), -np.sqrt(2.0), rtol=1e-8)


def test_bounds_one_sided():
    jsol = jnls.solve(jnls.NonlinearProblem(
        lambda u, p: u * u - p, jnp.array([0.5]), 2.0, lb=0.0),
        jnls.NewtonRaphson())
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: u * u - p, _t([0.5]), 2.0, lb=0.0),
        tnls.NewtonRaphson())
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    assert _rel(tsol.u.numpy(), np.asarray(jsol.u)) <= 1e-12
    np.testing.assert_allclose(float(tsol.u[0]), np.sqrt(2.0), rtol=1e-8)
    # an upper bound alone, on a shaped state with a tensor bound
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: u * u - p, -torch.ones((2, 2), dtype=torch.float64),
        2.0, ub=_t([[0.0, 0.0], [0.0, 0.0]])), tnls.NewtonRaphson())
    assert tsol.u.shape == (2, 2)
    np.testing.assert_allclose(tsol.u.numpy(), -np.sqrt(2.0), rtol=1e-8)


@pytest.mark.parametrize("name", ["Broyden", "DFSane", "TrustRegion"],
                         ids=["Broyden", "DFSane", "TR"])
def test_bounds_quasi_newton_and_spectral(name):
    jsol = jnls.solve(jnls.NonlinearProblem(
        lambda u, p: u * u - p, jnp.array([-1.0]), 2.0, lb=-2.0, ub=0.0),
        _alg(jnls, name))
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: u * u - p, _t([-1.0]), 2.0, lb=-2.0, ub=0.0),
        _alg(tnls, name))
    assert int(tsol.retcode) == int(jsol.retcode)
    assert _rel(tsol.u.numpy(), np.asarray(jsol.u)) <= 1e-10
    np.testing.assert_allclose(float(tsol.u[0]), -np.sqrt(2.0), rtol=1e-6)


def test_gradient_through_bounded_solve():
    """The rule on the bounded residual: reverse and forward mode."""
    def jgb(p):
        prob = jnls.NonlinearProblem(lambda u, q: u * u - q,
                                     jnp.array([-1.0]), p, lb=-3.0, ub=0.0)
        return jnls.solve(prob, jnls.NewtonRaphson()).u[0]

    def tgb(p):
        prob = tnls.NonlinearProblem(lambda u, q: u * u - q, _t([-1.0]), p,
                                     lb=-3.0, ub=0.0)
        return tnls.solve(prob, tnls.NewtonRaphson()).u[0]

    jg = float(jax.grad(jgb)(2.0))
    tg = tgrad(tgb, 2.0)
    assert _rel(tg, jg) <= DENSE_RTOL
    np.testing.assert_allclose(tg, -EXACT, rtol=1e-8)
    assert _rel(float(tjvp(tgb, 2.0)), jg) <= DENSE_RTOL


def test_precondition_left_transform():
    jsol = jnls.solve(jnls.NonlinearProblem(
        lambda u, p: u * u - p, jnp.array([1.0, 1.0]), 2.0),
        jnls.NewtonRaphson(), precondition=lambda fu, u, p: 2.0 * fu)
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: u * u - p, _t([1.0, 1.0]), 2.0),
        tnls.NewtonRaphson(), precondition=lambda fu, u, p: 2.0 * fu)
    assert tsol.success
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    assert _rel(tsol.u.numpy(), np.asarray(jsol.u)) <= 1e-12
    # the reported residual is the composed (preconditioned) one
    assert float(tsol.resid.abs().max()) < 1e-8
    np.testing.assert_allclose(tsol.resid.numpy(), np.asarray(jsol.resid),
                               atol=1e-14)
    # the rule runs on the composed residual: G = 2·fu keeps the root, and
    # with it the derivative
    p = _t(2.0).requires_grad_(True)
    u = tnls.solve(tnls.NonlinearProblem(lambda u, q: u * u - q,
                                         _t([1.0]), p), tnls.NewtonRaphson(),
                   precondition=lambda fu, u, q: 2.0 * fu).u[0]
    np.testing.assert_allclose(float(torch.autograd.grad(u, p)[0]), EXACT,
                               rtol=1e-10)


def test_postcondition_corrector():
    def jH(u_prop, u_prev, p):
        return jnp.clip(u_prop, -10.0, 10.0)

    def tH(u_prop, u_prev, p):
        return torch.clamp(u_prop, -10.0, 10.0)

    jsol = jnls.solve(jnls.NonlinearProblem(
        lambda u, p: u * u - p, jnp.array([1.0, 1.0]), 2.0),
        jnls.NewtonRaphson(), postcondition=jH)
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: u * u - p, _t([1.0, 1.0]), 2.0),
        tnls.NewtonRaphson(), postcondition=tH)
    assert tsol.success
    assert int(tsol.retcode) == int(jsol.retcode)
    assert {k: getattr(tsol.stats, k) for k in ("nsteps", "nf")} == \
        {k: int(getattr(jsol.stats, k)) for k in ("nsteps", "nf")}
    assert _rel(tsol.u.numpy(), np.asarray(jsol.u)) <= 1e-12
    np.testing.assert_allclose(tsol.u.numpy(), np.sqrt(2.0), rtol=1e-8)


def test_postcondition_specifier_with_bounds():
    jsol = jnls.solve(
        jnls.NonlinearProblem(lambda u, p: u * u - p, jnp.array([0.5]), 2.0,
                              lb=0.0, ub=10.0),
        jnls.NewtonRaphson(),
        postcondition=JPost(lambda up, upr, p: jnp.clip(up, 0.1, 5.0),
                            space="original"))
    tsol = tnls.solve(
        tnls.NonlinearProblem(lambda u, p: u * u - p, _t([0.5]), 2.0,
                              lb=0.0, ub=10.0),
        tnls.NewtonRaphson(),
        postcondition=TPost(lambda up, upr, p: torch.clamp(up, 0.1, 5.0),
                            space="original"))
    assert tsol.success
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tsol.stats.nsteps == int(jsol.stats.nsteps)
    assert _rel(tsol.u.numpy(), np.asarray(jsol.u)) <= 1e-12
    np.testing.assert_allclose(float(tsol.u[0]), np.sqrt(2.0), rtol=1e-8)
    with pytest.raises(ValueError, match="space"):
        TPost(lambda up, upr, p: up, space="sideways")


class TestNLLSSensitivity:
    """The rule through least squares: the stationarity system g = JᵀF,
    its Jacobian the exact Hessian (a nested vjp)."""

    ts = np.linspace(0.0, 1.0, 12)

    def _jfit(self, theta, alg, noise=0.0, abstol=None):
        ts = jnp.asarray(self.ts)
        target = theta[0] * jnp.exp(theta[1] * ts) + noise
        prob = jnls.NonlinearLeastSquaresProblem(
            lambda u, p: u[0] * jnp.exp(u[1] * ts) - p,
            jnp.array([1.0, -1.0]), target)
        kw = {} if abstol is None else {"abstol": abstol}
        return jnls.solve(prob, alg, **kw).u

    def _tfit(self, theta, alg, noise=0.0, abstol=None):
        ts = _t(self.ts)
        target = theta[0] * torch.exp(theta[1] * ts) + noise
        prob = tnls.NonlinearLeastSquaresProblem(
            lambda u, p: u[0] * torch.exp(u[1] * ts) - p, _t([1.0, -1.0]),
            target)
        kw = {} if abstol is None else {"abstol": abstol}
        return tnls.solve(prob, alg, **kw).u

    @pytest.mark.parametrize("name", ["GaussNewton", "LevenbergMarquardt"])
    def test_jacrev_exact_fit(self, name):
        th = np.array([2.0, -1.5])
        jJ = np.asarray(jax.jacrev(lambda t: self._jfit(
            t, _alg(jnls, name)))(jnp.asarray(th)))
        tJ = torch.autograd.functional.jacobian(
            lambda t: self._tfit(t, _alg(tnls, name)), _t(th))
        assert _rel(tJ.numpy(), jJ) <= DENSE_RTOL
        np.testing.assert_allclose(tJ.numpy(), np.eye(2), atol=1e-5)

    def test_jacfwd_nonzero_residual_matches_fd(self):
        noise = np.random.default_rng(0).standard_normal(12) * 0.1
        th = np.array([2.0, -1.5])
        jJ = np.asarray(jax.jacfwd(lambda t: self._jfit(
            t, jnls.GaussNewton(), jnp.asarray(noise), abstol=1e-12))(
            jnp.asarray(th)))
        cols = []
        for i in range(2):
            with fwAD.dual_level():
                d = fwAD.make_dual(_t(th), _t(np.eye(2)[i]))
                u = self._tfit(d, tnls.GaussNewton(), _t(noise),
                               abstol=1e-12)
                cols.append(fwAD.unpack_dual(u).tangent.numpy())
        tJ = np.column_stack(cols)
        # the fit's normal equations are ill-conditioned: the two packages'
        # minimizers differ by about 1.2e-10 (the exponentials round
        # differently), and the derivatives at them by as much; at the same
        # root, forward and reverse mode agree to rounding
        jroot = np.asarray(self._jfit(jnp.asarray(th), jnls.GaussNewton(),
                                      jnp.asarray(noise), abstol=1e-12))
        troot = self._tfit(_t(th), tnls.GaussNewton(), _t(noise),
                           abstol=1e-12).numpy()
        assert _rel(tJ, jJ) <= max(DENSE_RTOL, 4 * _rel(troot, jroot))
        tJr = torch.autograd.functional.jacobian(
            lambda t: self._tfit(t, tnls.GaussNewton(), _t(noise),
                                 abstol=1e-12), _t(th)).numpy()
        assert _rel(tJ, tJr) <= 1e-12
        # central differences with the JAX test's bound; a step of 1e-5
        # (the JAX test's 1e-6) keeps the roots' 1e-10 noise below it
        eps = 1e-5
        fd = np.column_stack([
            (self._tfit(_t(th + eps * np.eye(2)[i]), tnls.GaussNewton(),
                        _t(noise), abstol=1e-12).numpy()
             - self._tfit(_t(th - eps * np.eye(2)[i]), tnls.GaussNewton(),
                          _t(noise), abstol=1e-12).numpy()) / (2 * eps)
            for i in range(2)])
        np.testing.assert_allclose(tJ, fd, rtol=1e-4)

    def test_minres_branch(self, limit):
        """n = 2 above a limit of 1: MINRES on the Hessian's products."""
        limit(1)
        noise = np.random.default_rng(1).standard_normal(12) * 0.1
        th = np.array([2.0, -1.5])
        jJ = np.asarray(jax.jacrev(lambda t: self._jfit(
            t, jnls.GaussNewton(), jnp.asarray(noise), abstol=1e-12))(
            jnp.asarray(th)))
        tJ = torch.autograd.functional.jacobian(
            lambda t: self._tfit(t, tnls.GaussNewton(), _t(noise),
                                 abstol=1e-12), _t(th))
        assert tsens.STATS["branch"] == "minres"
        assert _rel(tJ.numpy(), jJ) <= KRYLOV_RTOL
        limit(2048)
        tJd = torch.autograd.functional.jacobian(
            lambda t: self._tfit(t, tnls.GaussNewton(), _t(noise),
                                 abstol=1e-12), _t(th))
        assert _rel(tJ.numpy(), tJd.numpy()) <= KRYLOV_RTOL


@pytest.mark.parametrize("name", ["DFSane", "AndersonAcceleration"])
def test_gradients_through_dfsane_anderson(name):
    """The rule covers the derivative-free engines too."""
    def make(m):
        return (m.AndersonAcceleration(beta=-0.5) if name != "DFSane"
                else m.DFSane())

    jg = float(jax.grad(lambda p: jnls.solve(jnls.NonlinearProblem(
        lambda u, q: u * u - q, jnp.array([1.0]), p), make(jnls)).u[0])(2.0))
    tg = tgrad(lambda p: tnls.solve(tnls.NonlinearProblem(
        lambda u, q: u * u - q, _t([1.0]), p), make(tnls)).u[0], 2.0)
    assert _rel(tg, jg) <= 1e-9
    np.testing.assert_allclose(tg, EXACT, rtol=1e-6)


def test_u0_and_no_grad_carry_no_derivative():
    """Tangents through u0 are zero (u0 is not an input of the rule), and
    a solve under ``torch.no_grad()`` returns a plain tensor."""
    u0 = _t([1.0]).requires_grad_(True)
    p = _t(2.0).requires_grad_(True)
    u = tnls.solve(tnls.NonlinearProblem(lambda u, q: u * u - q, u0, p),
                   tnls.NewtonRaphson()).u
    gu0, gp = torch.autograd.grad(u.sum(), [u0, p], allow_unused=True)
    assert gu0 is None
    np.testing.assert_allclose(float(gp), EXACT, rtol=1e-10)
    with torch.no_grad():
        u = tnls.solve(tnls.NonlinearProblem(lambda u, q: u * u - q,
                                             _t([1.0]), p),
                       tnls.NewtonRaphson()).u
    assert not u.requires_grad

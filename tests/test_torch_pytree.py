"""Pytree and 0-d states (``utils/pytree.py`` and the flat path of
``core/solve.py``) against the JAX package, f64 on the CPU.

``ravel_pytree`` is held to ``jax.flatten_util.ravel_pytree``: the leaf
order (dict keys sorted, ``None`` a node without leaves), the promoted
dtype (a Python number counts as its x64 default) and the values, then
``unravel`` back.
The solves on a dict state — ``test_pytree_state`` of
``tests/test_core_solvers.py`` under NewtonRaphson, Broyden and the other
engines, a 0-d state off the simple tier, a pytree residual on a tensor
state, the iterator, an ensemble, a continuation, the SciPy bridge and a
gradient through the root — each give the JAX package's retcode,
NLStats and leaves.  The residuals are written as XLA rounds them (a
fused ``u * u - p`` is ``torch.addcmul``: ROADMAP C, caveats), since the
secant engines carry the last bit of every residual.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as jravel

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu_torch.utils.pytree import (pytree_dataclass,
                                                   ravel_pytree,
                                                   static_config, tree_add,
                                                   tree_flatten, tree_scale,
                                                   tree_unflatten)

torch.set_num_threads(1)

F64 = torch.float64


def _t(x, dtype=F64):
    return torch.tensor(x, dtype=dtype)


# ---------------------------------------------------------------------------
# ravel_pytree
# ---------------------------------------------------------------------------

RAVEL_CASES = {
    "dict_sorted": (lambda m, dt: {"z": m.asarray([1.0, 2.0], dt),
                                   "a": m.asarray([[3.0], [4.0]], dt),
                                   "m": m.asarray(5.0, dt)}),
    "nested": (lambda m, dt: ({"b": m.asarray([1.0], dt), "a": None},
                              [m.asarray([2.0, 3.0], dt), 4.0])),
    "mixed_widths": (lambda m, dt: {"x": m.asarray([1.5], np.float32),
                                    "y": m.asarray([2.25], np.float64)}),
    "python_float": (lambda m, dt: (m.asarray([1.5, 2.5], np.float32), 0.25)),
    "python_complex": (lambda m, dt: (m.asarray([1.5], np.float32), 2j)),
    "complex_leaf": (lambda m, dt: {"c": m.asarray([1 + 2j], np.complex128),
                                    "r": m.asarray([3.0], np.float64)}),
    "python_only": (lambda m, dt: (1.0, 2.0)),
}


class _NP:
    """``asarray`` building numpy arrays (for the JAX side) or tensors."""

    def __init__(self, torch_side):
        self.torch_side = torch_side

    def asarray(self, x, dtype):
        a = np.asarray(x, dtype)
        return torch.as_tensor(a) if self.torch_side else jnp.asarray(a)


@pytest.mark.parametrize("case", sorted(RAVEL_CASES))
def test_ravel_pytree_matches_jax(case):
    make = RAVEL_CASES[case]
    jflat, junravel = jravel(make(_NP(False), np.float64))
    tree = make(_NP(True), np.float64)
    tflat, tunravel = ravel_pytree(tree)
    assert str(tflat.dtype).split(".")[-1] == jflat.dtype.name
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    back = tunravel(tflat * 2)
    jback = junravel(jflat * 2)
    tleaves, tspec = tree_flatten(back)
    jleaves = jax.tree_util.tree_leaves(jback)
    assert len(tleaves) == len(jleaves)
    for t, j in zip(tleaves, jleaves):
        assert tuple(t.shape) == tuple(np.shape(j))
        assert str(t.dtype).split(".")[-1] == np.asarray(j).dtype.name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tree_flatten(tree)[1] == tspec


def test_tree_helpers():
    @pytree_dataclass
    class State:
        a: torch.Tensor
        b: tuple

    s = State(_t([1.0]), (_t([2.0]), None))
    leaves, spec = tree_flatten(s)
    assert [float(x) for x in leaves] == [1.0, 2.0]
    s2 = tree_unflatten(spec, [x * 3 for x in leaves])
    assert isinstance(s2, State) and float(s2.b[0]) == 6.0
    assert float(tree_add(s, s2).a) == 4.0
    assert float(tree_scale(s, 0.5).b[0]) == 1.0
    assert s.replace(a=_t([9.0])).a.item() == 9.0

    @static_config
    class Cfg:
        k: int = 2
    assert Cfg() == Cfg() and hash(Cfg()) == hash(Cfg())
    assert Cfg().replace(k=3).k == 3


# ---------------------------------------------------------------------------
# solves on pytree and 0-d states
# ---------------------------------------------------------------------------

def _jf(u, p):
    return {"b": u["b"] ** 3 - p, "a": u["a"] ** 2 - p}


def _tf(u, p):
    """``_jf`` as XLA rounds it: each power and its subtraction fused."""
    mp = -torch.as_tensor(p, dtype=F64)
    return {"b": torch.addcmul(mp, u["b"] * u["b"], u["b"]),
            "a": torch.addcmul(mp, u["a"], u["a"])}


def _ju0():
    return {"b": jnp.array([1.0]), "a": jnp.array([1.0, 1.5])}


def _tu0():
    return {"b": _t([1.0]), "a": _t([1.0, 1.5])}


def _stats(sol):
    s = sol.stats
    return [int(s.nf), int(s.njacs), int(s.nfactors), int(s.nsolve),
            int(s.nsteps)]


def _same(jsol, tsol, atol=0.0):
    assert int(tsol.retcode) == int(jsol.retcode)
    assert _stats(tsol) == _stats(jsol)
    jl = jax.tree_util.tree_leaves(jsol.u)
    tl = tree_flatten(tsol.u)[0]
    assert len(jl) == len(tl)
    for j, t in zip(jl, tl):
        assert tuple(t.shape) == tuple(np.shape(j))
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("name", ["NewtonRaphson", "Broyden", "Klement",
                                  "TrustRegion", "LevenbergMarquardt",
                                  "DFSane", "SimpleNewtonRaphson"])
def test_pytree_state(name):
    """tests/test_core_solvers.py::test_pytree_state and the engines on a
    dict state: the JAX package's retcode, NLStats and leaves."""
    jsol = jnls.solve(jnls.NonlinearProblem(_jf, _ju0(), 2.0),
                      getattr(jnls, name)())
    tsol = tnls.solve(tnls.NonlinearProblem(_tf, _tu0(), 2.0),
                      getattr(tnls, name)())
    assert isinstance(tsol.u, dict) and isinstance(tsol.resid, dict)
    # LM's SVD least squares rounds otherwise (ROADMAP C, caveats)
    _same(jsol, tsol, atol=1e-14 if name == "LevenbergMarquardt" else 0.0)
    np.testing.assert_allclose(tsol.u["a"].numpy(), 2 ** 0.5, rtol=1e-8)
    np.testing.assert_allclose(tsol.u["b"].numpy(), 2 ** (1 / 3), rtol=1e-8)


@pytest.mark.parametrize("name", ["NewtonRaphson", "TrustRegion", "Broyden",
                                  "DFSane"])
def test_zero_dim_state(name):
    """tests/test_core_solvers.py::test_scalar_problem off the simple tier:
    a 0-d u0 solved on the flat path and given back 0-d."""
    jsol = jnls.solve(jnls.NonlinearProblem(lambda u, p: u * u - p,
                                            jnp.asarray(1.0), 2.0),
                      getattr(jnls, name)())
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: torch.addcmul(_t(-p), u, u), _t(1.0), 2.0),
        getattr(tnls, name)())
    assert tsol.u.shape == () and tsol.resid.shape == ()
    _same(jsol, tsol)


def test_pytree_residual_on_a_tensor_state():
    """A tuple residual of a tensor state runs flat (its leaves raveled in
    order), the JAX package's rule."""
    def jf(u, p):
        return (u[:2] ** 2 - p, jnp.sum(u) - 3.0)

    def tf(u, p):
        return (torch.addcmul(_t(-p), u[:2], u[:2]), torch.sum(u) - 3.0)
    jsol = jnls.solve(jnls.NonlinearProblem(jf, jnp.array([1.0, 1.5, 0.5]),
                                            2.0), jnls.NewtonRaphson())
    tsol = tnls.solve(tnls.NonlinearProblem(tf, _t([1.0, 1.5, 0.5]), 2.0),
                      tnls.NewtonRaphson())
    assert isinstance(tsol.resid, tuple) and tsol.resid[1].shape == ()
    _same(jsol, tsol)


def test_pytree_iterator():
    """``init`` → ``step`` → ``solve`` on a dict state: the plain solve's
    retcode, NLStats and leaves; ``cache.u`` is a dict."""
    prob = tnls.NonlinearProblem(_tf, _tu0(), 2.0)
    ref = tnls.solve(prob, tnls.Broyden())
    cache = tnls.init(prob, tnls.Broyden())
    cache.step(3)
    assert isinstance(cache.u, dict) and cache.u["a"].shape == (2,)
    assert isinstance(cache.fu, dict)
    sol = cache.solve()
    assert _stats(sol) == _stats(ref)
    for k in "ab":
        assert torch.equal(sol.u[k], ref.u[k])


@pytest.mark.parametrize("name", ["NewtonRaphson", "SimpleNewtonRaphson"])
def test_pytree_ensemble(name):
    """u0s as a dict with a leading batch axis: the JAX package's vmapped
    solve, row for row (a lockstep batch on the simple tier)."""
    u0s = {"b": np.array([[1.0], [0.8], [1.3]]),
           "a": np.array([[1.0, 1.5], [0.7, 2.0], [1.2, 1.1]])}
    jsol = jnls.solve_ensemble(jnls.NonlinearProblem(_jf, _ju0(), 2.0),
                               getattr(jnls, name)(),
                               u0s={k: jnp.asarray(v) for k, v in
                                    u0s.items()})
    tsol = tnls.solve_ensemble(tnls.NonlinearProblem(_tf, _tu0(), 2.0),
                               getattr(tnls, name)(),
                               u0s={k: _t(v) for k, v in u0s.items()})
    np.testing.assert_array_equal(tsol.retcode.numpy(),
                                  np.asarray(jsol.retcode))
    np.testing.assert_array_equal(tsol.stats.nsteps.numpy(),
                                  np.asarray(jsol.stats.nsteps))
    for k in "ab":
        assert tuple(tsol.u[k].shape) == u0s[k].shape
        np.testing.assert_allclose(tsol.u[k].numpy(), np.asarray(jsol.u[k]),
                                   rtol=0, atol=1e-15)


def test_pytree_continuation():
    """A HomotopyProblem on a dict state under the sweep (NewtonRaphson
    inner): the JAX package's retcode, NLStats, last λ and leaves."""
    def jH(u, p, lam):
        return {"y": u["y"] ** 3 - lam * p, "x": u["x"] - lam * u["y"]}

    def tH(u, p, lam):
        return {"y": torch.addcmul(-lam * p, u["y"] * u["y"], u["y"]),
                "x": u["x"] - lam * u["y"]}
    jsol = jnls.solve(jnls.HomotopyProblem(
        jH, {"y": jnp.array([1.0]), "x": jnp.array([0.0, 0.5])}, 8.0),
        jnls.HomotopySweep(inner=jnls.NewtonRaphson()), abstol=1e-10)
    tsol = tnls.solve(tnls.HomotopyProblem(
        tH, {"y": _t([1.0]), "x": _t([0.0, 0.5])}, 8.0),
        tnls.HomotopySweep(inner=tnls.NewtonRaphson()), abstol=1e-10)
    assert int(tsol.retcode) == int(jsol.retcode)
    assert [tsol.stats.nf, tsol.stats.nsteps] == \
        [int(jsol.stats.nf), int(jsol.stats.nsteps)]
    assert float(tsol.original) == float(jsol.original)
    for k in "xy":
        np.testing.assert_allclose(tsol.u[k].numpy(), np.asarray(jsol.u[k]),
                                   rtol=0, atol=1e-14)


def test_pytree_scipy_bridge():
    """SciPyRoot on a dict state: the host solver on the raveled state,
    the root given back as a dict, the JAX package's root."""
    jsol = jnls.solve(jnls.NonlinearProblem(_jf, _ju0(), 2.0),
                      jnls.SciPyRoot("hybr"))
    tsol = tnls.solve(tnls.NonlinearProblem(_tf, _tu0(), 2.0),
                      tnls.SciPyRoot("hybr"))
    assert int(tsol.retcode) == int(jsol.retcode)
    for k in "ab":
        np.testing.assert_allclose(tsol.u[k].numpy(), np.asarray(jsol.u[k]),
                                   rtol=1e-12)


def test_pytree_state_gradient():
    """∂(Σ u["a"] + 2 Σ u["b"])/∂p through a dict-state solve by the
    implicit-function rule: the JAX package's jax.grad, reverse and
    forward mode."""
    def jloss(p):
        sol = jnls.solve(jnls.NonlinearProblem(_jf, _ju0(), p),
                         jnls.NewtonRaphson(), abstol=1e-12)
        return jnp.sum(sol.u["a"]) + 2 * jnp.sum(sol.u["b"])
    jg = float(jax.grad(jloss)(2.0))
    p = _t(2.0).requires_grad_(True)
    sol = tnls.solve(tnls.NonlinearProblem(_tf, _tu0(), p),
                     tnls.NewtonRaphson(), abstol=1e-12)
    loss = sol.u["a"].sum() + 2 * sol.u["b"].sum()
    (tg,) = torch.autograd.grad(loss, p)
    np.testing.assert_allclose(float(tg), jg, rtol=1e-12)
    from torch.autograd import forward_ad
    with forward_ad.dual_level():
        pd = forward_ad.make_dual(_t(2.0), _t(1.0))
        sol = tnls.solve(tnls.NonlinearProblem(_tf, _tu0(), pd),
                         tnls.NewtonRaphson(), abstol=1e-12)
        ta = forward_ad.unpack_dual(sol.u["a"]).tangent
        tb = forward_ad.unpack_dual(sol.u["b"]).tangent
    np.testing.assert_allclose(float(ta.sum() + 2 * tb.sum()), jg,
                               rtol=1e-12)

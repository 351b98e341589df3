"""The quasi-Newton, spectral and Anderson building blocks of the port
against the JAX package's, f64 on the CPU, on seeded inputs: the
stored-Jacobian initialisation, every update rule on every structure
(inverse and direct), the low-rank ring's products, the two reset rules,
``resolve_low_rank``, Anderson's masked normal equations and DF-SANE's
first σ; and the algorithms' constructor refusals and fields.

The JAX functions run under ``jax.jit``, as inside its engines, where XLA
contracts ``a + b·c`` into one rounding: bit-equal where one such rounding
decides (Klement's diagonal update, the ring masks, the reset flags),
else rel-inf 1e-13 (products and sums whose order XLA picks)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.solvers import anderson as jand
from nonlinearsolve_tpu.solvers import quasi_newton as jqn
from nonlinearsolve_tpu.solvers import spectral as jsp
from nonlinearsolve_tpu_torch.solvers import anderson as tand
from nonlinearsolve_tpu_torch.solvers import quasi_newton as tqn
from nonlinearsolve_tpu_torch.solvers import spectral as tsp

torch.set_num_threads(1)

RTOL = 1e-13


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(x):
    return torch.tensor(np.asarray(x))


# every (rule, structure, storage) the engine can update
UPDATE_ALGS = {
    "good_broyden_full_inverse": lambda m: m.Broyden(),
    "bad_broyden_full_inverse": lambda m: m.Broyden(
        update_rule="bad_broyden"),
    "good_broyden_diagonal_inverse": lambda m: m.Broyden(
        update_rule="diagonal"),
    "bad_broyden_diagonal_inverse": lambda m: m.QuasiNewtonAlgorithm(
        update_rule="bad_broyden", structure="diagonal"),
    "good_broyden_full_direct": lambda m: m.QuasiNewtonAlgorithm(
        trustregion=m.GenericTrustRegionScheme()),
    "klement_diagonal_direct": lambda m: m.Klement(),
    "klement_full_direct": lambda m: m.Klement(
        init_jacobian="true_jacobian"),
}
BIT_EQUAL = {"klement_diagonal_direct"}


@pytest.mark.parametrize("name", list(UPDATE_ALGS))
@pytest.mark.parametrize("n", [2, 5, 10])
def test_update_jacobian_matches_jax(name, n):
    ja, ta = UPDATE_ALGS[name](jnls), UPDATE_ALGS[name](tnls)
    upd = jax.jit(functools.partial(jqn._update_jacobian, ja))
    rng = np.random.default_rng(n)
    for _ in range(10):
        diag = ja.structure == "diagonal"
        J = rng.standard_normal(n if diag else (n, n))
        fu, fu_prev, u, du = (rng.standard_normal(n) for _ in range(4))
        want = np.asarray(upd(J, fu, fu_prev, u, du))
        got = tqn._update_jacobian(ta, _t(J), _t(fu), _t(fu_prev), _t(u),
                                   _t(du)).numpy()
        if name in BIT_EQUAL:
            assert np.array_equal(got, want)
        else:
            assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("name", list(UPDATE_ALGS))
def test_update_jacobian_zero_denominators_match_jax(name):
    """du = 0 and fu = fu_prev make every denominator 0: the 1e-5 guard."""
    ja, ta = UPDATE_ALGS[name](jnls), UPDATE_ALGS[name](tnls)
    n = 4
    J = np.arange(1.0, 1 + (n if ja.structure == "diagonal" else n * n))
    J = J if ja.structure == "diagonal" else J.reshape(n, n)
    z, f = np.zeros(n), np.linspace(1.0, 2.0, n)
    want = np.asarray(jax.jit(functools.partial(jqn._update_jacobian, ja))(
        J, f, f, z, z))
    got = tqn._update_jacobian(ta, _t(J), _t(f), _t(f), _t(z), _t(z))
    np.testing.assert_array_equal(got.numpy(), want)


def _ring(rng, eta, n, count):
    U, V = rng.standard_normal((eta, n)), rng.standard_normal((eta, n))
    return U, V, count, 0.7


@pytest.mark.parametrize("count", [0, 1, 3, 5, 9])
def test_low_rank_products_and_update_match_jax(count):
    rng = np.random.default_rng(count)
    eta, n = 5, 8
    U, V, c, a = _ring(rng, eta, n, count)
    jJ = (jnp.asarray(U), jnp.asarray(V), jnp.int32(c), jnp.float64(a))
    tJ = (_t(U), _t(V), c, torch.tensor(a, dtype=torch.float64))
    v = rng.standard_normal(n)
    for jf, tf in ((jqn._lr_matvec, tqn._lr_matvec),
                   (jqn._lr_rmatvec, tqn._lr_rmatvec)):
        want = np.asarray(jax.jit(jf)(jJ, v))
        assert _rel(tf(tJ, _t(v)).numpy(), want) <= RTOL
    ja = jqn.resolve_low_rank(jnls.LimitedMemoryBroyden(threshold=eta), n)
    ta = tqn.resolve_low_rank(tnls.LimitedMemoryBroyden(threshold=eta), n)
    fu, fu_prev, u, du = (rng.standard_normal(n) for _ in range(4))
    want = jax.jit(functools.partial(jqn._update_jacobian, ja))(
        jJ, fu, fu_prev, u, du)
    got = tqn._update_jacobian(ta, tJ, _t(fu), _t(fu_prev), _t(u), _t(du))
    assert got[2] == int(want[2]) == count + 1
    for g, w in zip(got[:2], want[:2]):
        assert _rel(g.numpy(), w) <= RTOL
    # the rows the update did not write are the inputs, bit for bit
    slot = count % eta
    keep = [i for i in range(eta) if i != slot]
    np.testing.assert_array_equal(got[0].numpy()[keep], U[keep])
    np.testing.assert_array_equal(tJ[0].numpy(), U)   # input untouched
    # the descent: -α·fu on an empty ring, else -matvec
    jd, jok = jqn._qn_descent(ja, jJ, jnp.asarray(fu))
    td, tok = tqn._qn_descent(ta, tJ, _t(fu))
    assert _rel(td.numpy(), np.asarray(jd)) <= RTOL and bool(tok) == \
        bool(jok)


INIT_ALGS = {
    "broyden_identity": lambda m: m.Broyden(),
    "broyden_alpha": lambda m: m.Broyden(alpha=2.5),
    "broyden_true_jacobian": lambda m: m.Broyden(
        init_jacobian="true_jacobian"),
    "broyden_diagonal": lambda m: m.Broyden(update_rule="diagonal"),
    "klement_identity": lambda m: m.Klement(),
    "klement_true_jacobian": lambda m: m.Klement(
        init_jacobian="true_jacobian"),
    "klement_true_jacobian_diagonal": lambda m: m.Klement(
        init_jacobian="true_jacobian_diagonal"),
    "broyden_trust_region": lambda m: m.QuasiNewtonAlgorithm(
        trustregion=m.GenericTrustRegionScheme(),
        init_jacobian="true_jacobian"),
    "lbroyden": lambda m: m.LimitedMemoryBroyden(threshold=3),
}

_A = np.random.default_rng(7).standard_normal((6, 6)) + 4 * np.eye(6)


def _jf(u):
    return jnp.asarray(_A) @ u + jnp.sin(u)


def _tf(u):
    return _t(_A) @ u + torch.sin(u)


@pytest.mark.parametrize("name", list(INIT_ALGS))
@pytest.mark.parametrize("scale", [1.0, 1e-7])
def test_init_J_matches_jax(name, scale):
    """``scale`` 1e-7 puts ‖fu‖ under 1e-5: α falls back to 1."""
    ja, ta = INIT_ALGS[name](jnls), INIT_ALGS[name](tnls)
    ja, ta = jqn.resolve_low_rank(ja, 6), tqn.resolve_low_rank(ta, 6)
    u = np.random.default_rng(1).standard_normal(6) * scale
    fu = np.asarray(_jf(jnp.asarray(u)))
    want = jax.jit(lambda u, fu: jqn._init_J(ja, jax.jacfwd(_jf), u, fu))(
        u, fu)
    got = tqn._init_J(ta, torch.func.jacfwd(_tf), _t(u), _t(fu))
    if ja.structure == "low_rank":
        assert got[2] == int(want[2]) == 0
        assert _rel(got[3].numpy(), want[3]) <= RTOL
        assert not got[0].any() and not got[1].any()
        return
    assert got.shape == want.shape
    assert _rel(got.numpy(), np.asarray(want)) <= RTOL


def test_resolve_low_rank_matches_jax():
    for th, n in ((27, 10), (27, 27), (27, 28), (2, 3), (5, 5)):
        j = jqn.resolve_low_rank(jnls.LimitedMemoryBroyden(threshold=th), n)
        t = tqn.resolve_low_rank(tnls.LimitedMemoryBroyden(threshold=th), n)
        assert j.structure == t.structure
    assert tqn.resolve_low_rank(tnls.Broyden(), 3).structure == "full"


def _j_state(s_du, s_dfu, dfu_prev):
    return jqn.ResetRuleState(steps_since_change_du=jnp.int32(s_du),
                              steps_since_change_dfu=jnp.int32(s_dfu),
                              dfu_prev=jnp.asarray(dfu_prev))


@pytest.mark.parametrize("rule", [
    dict(), dict(check_du=False), dict(check_dfu=False),
    dict(reset_tolerance=0.05), dict(nsteps=2)])
def test_no_change_reset_matches_jax(rule):
    """Ten checks in a row on seeded (fu, du) with small entries mixed in:
    the same reset decisions and counters in both packages."""
    jr, tr = jqn.NoChangeInStateReset(**rule), tqn.NoChangeInStateReset(
        **rule)
    alg_j, alg_t = jnls.Broyden(), tnls.Broyden()
    check = jax.jit(lambda st, fu, du: jqn._reset_check(
        alg_j, jr, st, None, fu, fu, du))
    rng = np.random.default_rng(3)
    n = 4
    fu0 = rng.standard_normal(n)
    js, ts = _j_state(0, 0, fu0), tqn.ResetRuleState(0, 0, _t(fu0))
    fu = fu0
    for k in range(10):
        small = rng.random() < 0.6
        du = rng.standard_normal(n) * (1e-13 if small else 1.0)
        fu = fu + (rng.standard_normal(n) * (1e-14 if rng.random() < 0.6
                                             else 1.0))
        jreset, js = check(js, jnp.asarray(fu), jnp.asarray(du))
        treset, ts = tqn._reset_check(alg_t, tr, ts, None, _t(fu), _t(fu),
                                      _t(du))
        assert bool(jreset) == treset, k
        assert (int(js.steps_since_change_du),
                int(js.steps_since_change_dfu)) == \
            (ts.steps_since_change_du, ts.steps_since_change_dfu), k
        np.testing.assert_array_equal(ts.dfu_prev.numpy(),
                                      np.asarray(js.dfu_prev))


@pytest.mark.parametrize("J", [
    np.array([1.0, 2.0, 3.0]), np.array([1.0, 0.0, 3.0]),
    np.diag([1.0, 2.0, 3.0]), np.diag([1.0, 1e-9, 3.0]),
    np.diag([1.0, 0.0, 3.0]), np.array([[1.0, 2.0, 0.0], [2.0, 4.0, 0.0],
                                        [0.0, 0.0, 1.0]]),
    np.array([[np.nan, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])],
    ids=["diag", "diag-zero", "full", "full-ill", "full-singular",
         "full-rank-deficient", "full-nan"])
def test_ill_conditioned_reset_matches_jax(J):
    structure = "diagonal" if J.ndim == 1 else "full"
    alg_j = jnls.QuasiNewtonAlgorithm(update_rule="klement",
                                      structure=structure)
    alg_t = tnls.QuasiNewtonAlgorithm(update_rule="klement",
                                      structure=structure)
    rule_j, rule_t = jqn.IllConditionedJacobianReset(), \
        tqn.IllConditionedJacobianReset()
    fu = np.ones(3)
    jreset, _ = jqn._reset_check(alg_j, rule_j, _j_state(0, 0, fu),
                                 jnp.asarray(J), jnp.asarray(fu), None, None)
    treset, _ = tqn._reset_check(alg_t, rule_t,
                                 tqn.ResetRuleState(0, 0, _t(fu)), _t(J),
                                 _t(fu), None, None)
    assert bool(jreset) == treset


@pytest.mark.parametrize("hist", [0, 1, 3, 5])
def test_anderson_gamma_matches_jax(hist):
    rng = np.random.default_rng(hist)
    m, n = 5, 9
    dF, fu = rng.standard_normal((m, n)), rng.standard_normal(n)
    mask = (np.arange(m) < hist).astype(np.float64)
    want = np.asarray(jax.jit(jand._anderson_gamma)(dF, fu, mask, 1e-10))
    got = tand._anderson_gamma(_t(dF), _t(fu), _t(mask),
                               torch.tensor(1e-10, dtype=torch.float64))
    assert np.array_equal(got.numpy() == 0, want == 0)
    if hist:
        assert _rel(got.numpy(), want) <= 1e-12


@pytest.mark.parametrize("case", ["plain", "orthogonal", "out_of_bounds",
                                  "sigma_1"])
def test_initial_sigma_matches_jax(case):
    u, fu = np.array([1.0, 2.0, -0.5]), np.array([0.3, 0.1, 0.2])
    kw = {}
    if case == "orthogonal":         # ⟨u, fu⟩ = 0: the fallback
        fu = np.array([2.0, -1.0, 0.0])
    elif case == "out_of_bounds":    # σ ≈ 1e12 > σ_max
        fu = u * 1e-12
    elif case == "sigma_1":
        kw = dict(sigma_1=0.25)
    ja = jnls.GeneralizedDFSane(**kw)
    ta = tnls.GeneralizedDFSane(**kw)
    want = float(jax.jit(functools.partial(jsp._initial_sigma, ja))(u, fu))
    got = float(tsp._initial_sigma(ta, _t(u), _t(fu)))
    assert got == pytest.approx(want, rel=RTOL)


def test_post_init_refusals_match_jax():
    for m in (jnls, tnls):
        tr = m.GenericTrustRegionScheme()
        with pytest.raises(ValueError, match="linesearch and trustregion"):
            m.QuasiNewtonAlgorithm(trustregion=tr,
                                   linesearch=m.BackTracking())
        with pytest.raises(ValueError, match="GenericTrustRegionScheme"):
            m.QuasiNewtonAlgorithm(
                trustregion=m.LevenbergMarquardtTrustRegion())
        with pytest.raises(ValueError, match="full"):
            m.QuasiNewtonAlgorithm(structure="diagonal", trustregion=tr)
        with pytest.raises(ValueError, match="bad_broyden"):
            m.QuasiNewtonAlgorithm(update_rule="bad_broyden",
                                   trustregion=tr)


CONSTRUCTED = [
    lambda m: m.Broyden(), lambda m: m.Broyden(update_rule="diagonal"),
    lambda m: m.Broyden(update_rule="bad_broyden",
                        init_jacobian="true_jacobian", max_resets=7),
    lambda m: m.Klement(), lambda m: m.Klement(init_jacobian="true_jacobian"),
    lambda m: m.Klement(init_jacobian="true_jacobian_diagonal"),
    lambda m: m.LimitedMemoryBroyden(threshold=5, reset_tolerance=1e-9),
    lambda m: m.QuasiNewtonAlgorithm(trustregion=m.GenericTrustRegionScheme()),
]
FIELDS = ("update_rule", "structure", "threshold", "init_jacobian", "alpha",
          "max_resets", "tr_reset_rejects", "max_shrink_times", "name",
          "store_inverse")


@pytest.mark.parametrize("k", range(len(CONSTRUCTED)))
def test_constructors_match_jax(k):
    j, t = CONSTRUCTED[k](jnls), CONSTRUCTED[k](tnls)
    assert {f: getattr(j, f) for f in FIELDS} == \
        {f: getattr(t, f) for f in FIELDS}
    assert type(j.reinit_rule).__name__ == type(t.reinit_rule).__name__
    if hasattr(j.reinit_rule, "nsteps"):
        assert vars(j.reinit_rule) == vars(t.reinit_rule)


def test_dfsane_and_anderson_constructors_match_jax():
    j, t = jnls.DFSane(M=5, gamma=1e-3), tnls.DFSane(M=5, gamma=1e-3)
    assert (j.sigma_min, j.sigma_max, j.sigma_1, j.name) == \
        (t.sigma_min, t.sigma_max, t.sigma_1, t.name)
    assert {k: getattr(j.linesearch, k) for k in vars(t.linesearch)} == \
        vars(t.linesearch)
    j, t = jnls.AndersonAcceleration(m=3), tnls.AndersonAcceleration(m=3)
    assert (j.m, j.beta, j.regularization) == (t.m, t.beta,
                                               t.regularization)

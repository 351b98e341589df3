"""Double-f32 arithmetic (``ops/doublef32.py``), the hand-written
``brusselator_2d_df32`` and the graph evaluator ``df_eval``
(``ops/doublef32_eval.py``) against the JAX package on the CPU (ROADMAP
A.27).

- The error-free transforms, the double-word arithmetic, the compensated
  sum and dot, exp, sin, cos and expm1 give the JAX package's words bit
  for bit on seeded f32 arrays.  log and log1p's large branch start their
  Newton step from ``torch.log`` of the high word, which rounds
  differently from XLA's f32 log in the last ulp, so they are held to the
  JAX value within 1e-13 relative (measured 4.6e-15 and 2.9e-14; each
  package is within 3.5e-14 of the exact value);
- ``brusselator_2d_df32`` at N = 16: the JAX package's words bit for bit;
- ``df_eval`` on ``TestDFEval``'s expressions within 1e-13 relative of
  the JAX package's double-word value, with the wide-trace guard's
  warning, ``register_df_rule``, ``first_order_rules`` and the guidance
  error.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.ops import doublef32 as J
from nonlinearsolve_tpu.ops.doublef32_eval import df_eval as jdf_eval
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.ops import doublef32 as T
from nonlinearsolve_tpu_torch.ops import doublef32_eval as tdfe

torch.set_num_threads(1)

aten = torch.ops.aten


def _jdf(v64):
    return J.df_from_f64(v64)


def _tdf(v64):
    return T.df_from_f64(v64, device="cpu")


def _bits_equal(j, t):
    for a, b in ((j.hi, t.hi), (j.lo, t.lo)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


RNG = np.random.default_rng(0)
A64 = RNG.standard_normal(4096) * 1e3
B64 = RNG.standard_normal(4096) + 2.0
X64 = RNG.uniform(-3.0, 3.0, 4096)
P64 = RNG.uniform(0.1, 5.0, 4096)


@pytest.mark.parametrize("op", ["df_add", "df_sub", "df_mul", "df_div"])
def test_arithmetic_words_equal_jax(op):
    _bits_equal(getattr(J, op)(_jdf(A64), _jdf(B64)),
                getattr(T, op)(_tdf(A64), _tdf(B64)))
    got = T.df_value_f64(getattr(T, op)(_tdf(A64), _tdf(B64)))
    want = {"df_add": A64 + B64, "df_sub": A64 - B64, "df_mul": A64 * B64,
            "df_div": A64 / B64}[op]
    assert (np.abs(got - want) / np.abs(want)).max() < 1e-13


def test_transforms_and_reductions_equal_jax():
    a32, b32 = A64.astype(np.float32), B64.astype(np.float32)
    for name in ("two_sum", "fast_two_sum", "two_prod"):
        j = J.DF(*getattr(J, name)(jnp.asarray(a32), jnp.asarray(b32)))
        t = T.DF(*getattr(T, name)(torch.tensor(a32), torch.tensor(b32)))
        _bits_equal(j, t)
    s, e = T.two_sum(torch.tensor(a32), torch.tensor(b32))
    np.testing.assert_array_equal(
        s.double().numpy() + e.double().numpy(),
        a32.astype(np.float64) + b32.astype(np.float64))
    p, e = T.two_prod(torch.tensor(a32), torch.tensor(b32))
    np.testing.assert_array_equal(
        p.double().numpy() + e.double().numpy(),
        a32.astype(np.float64) * b32.astype(np.float64))
    _bits_equal(J.df_add_f(_jdf(A64), jnp.asarray(b32)),
                T.df_add_f(_tdf(A64), torch.tensor(b32)))
    _bits_equal(J.df_mul_f(_jdf(A64), jnp.asarray(b32)),
                T.df_mul_f(_tdf(A64), torch.tensor(b32)))
    _bits_equal(J.df_sum(_jdf(A64[:3000])), T.df_sum(_tdf(A64[:3000])))
    _bits_equal(J.df_dot(_jdf(A64), _jdf(B64)), T.df_dot(_tdf(A64),
                                                         _tdf(B64)))
    _bits_equal(J.df_roll(_jdf(A64), 3, 0), T.df_roll(_tdf(A64), 3, 0))
    v64 = np.random.default_rng(3).standard_normal(100_000)
    got = T.df_value_f64(T.df_sum(_tdf(v64)))
    assert abs(got - v64.sum()) / abs(v64.sum()) < 1e-10
    assert T.self_check("cpu")


@pytest.mark.parametrize("op,x", [("df_exp", X64), ("df_sin", X64),
                                  ("df_cos", X64), ("df_expm1", X64 * 0.2),
                                  ("df_log", P64), ("df_log1p", X64 * 0.1)])
def test_transcendentals_equal_jax(op, x):
    j = getattr(J, op)(_jdf(x))
    t = getattr(T, op)(_tdf(x))
    if op in ("df_log", "df_log1p"):
        jv, tv = J.df_value_f64(j), T.df_value_f64(t)
        assert (np.abs(tv - jv) / np.abs(jv).max()).max() < 1e-13
    else:
        _bits_equal(j, t)


def test_small_expm1_log1p_keep_double_word_accuracy():
    xs = np.array([1e-10, 1e-6, 1e-3, 0.02, 0.0499, 0.05, 0.0501, 0.09,
                   0.0999, 0.3, 2.0, -1e-8, -0.0499, -0.0501, -0.09,
                   -0.4], np.float32)
    x = T.DF(torch.tensor(xs), torch.zeros(xs.shape, dtype=torch.float32))
    x64 = xs.astype(np.float64)
    rel = np.abs((T.df_value_f64(T.df_expm1(x)) - np.expm1(x64))
                 / np.expm1(x64))
    assert rel.max() < 1e-13
    rel2 = np.abs((T.df_value_f64(T.df_log1p(x)) - np.log1p(x64))
                  / np.log1p(x64))
    assert rel2.max() < 1e-13


def test_brusselator_df32_equals_jax():
    N = 16
    U32 = np.asarray(jbru.init_u0(N, jnp.float32))
    lo = (np.random.default_rng(1).standard_normal(U32.shape)
          * 1e-9).astype(np.float32)
    p64 = np.asarray(jbru.default_p(N, jnp.float64))
    jh, jl = jbru.brusselator_2d_df32(jnp.asarray(U32), jnp.asarray(lo), p64)
    th, tl = tbru.brusselator_2d_df32(torch.tensor(U32), torch.tensor(lo),
                                      torch.tensor(p64))
    _bits_equal(J.DF(jh, jl), T.DF(th, tl))
    f64 = tbru.brusselator_2d(torch.tensor(U32, dtype=torch.float64)
                              + torch.tensor(lo, dtype=torch.float64),
                              torch.tensor(p64)).numpy()
    err = np.abs(th.double().numpy() + tl.double().numpy() - f64).max()
    assert err < 1e-10 * max(np.abs(f64).max(), 1.0)


# ---------------------------------------------------------------------------
# df_eval
# ---------------------------------------------------------------------------


def _jsplit(v64):
    hi = jnp.asarray(v64, jnp.float32)
    return J.DF(hi, jnp.asarray(v64 - np.asarray(hi, np.float64),
                                jnp.float32))


def _close_to_jax(jout, tout, rel=1e-13):
    jv, tv = J.df_value_f64(jout), T.df_value_f64(tout)
    assert np.abs(tv - jv).max() <= rel * max(np.abs(jv).max(), 1e-300)


def test_df_eval_mixed_expression():
    def jf(u):
        w = jnp.roll(u, 1) + jnp.roll(u, -1) - 2.0 * u
        return (1e6 * w + u ** 3 * 2.5 - jnp.sqrt(jnp.abs(u) + 1.0)
                + jnp.sum(u ** 2) / (1.0 + u ** 2))

    def tf(u):
        w = torch.roll(u, 1) + torch.roll(u, -1) - 2.0 * u
        return (1e6 * w + u ** 3 * 2.5 - torch.sqrt(torch.abs(u) + 1.0)
                + torch.sum(u ** 2) / (1.0 + u ** 2))

    u64 = np.random.default_rng(0).standard_normal(128) * 3
    tout = tdfe.df_eval(tf, _tdf(u64))
    _close_to_jax(jdf_eval(jf, _jsplit(u64)), tout)
    want = np.asarray(jf(jnp.asarray(T.df_value_f64(_tdf(u64)))))
    assert np.abs(T.df_value_f64(tout) - want).max() \
        < 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("case", ["scaled_roll", "matvec", "pow15",
                                  "transcendentals", "where_max"])
def test_df_eval_expressions_match_jax(case):
    rng = np.random.default_rng(1)
    u64 = rng.standard_normal(64)
    if case == "scaled_roll":
        jf = lambda u: 1e6 * (jnp.roll(u, 1) - u) + u ** 3   # noqa: E731
        tf = lambda u: 1e6 * (torch.roll(u, 1) - u) + u ** 3  # noqa: E731
        _close_to_jax(jdf_eval(jf, _jsplit(u64)), tdfe.df_eval(tf, _tdf(u64)))
    elif case == "matvec":
        A64 = rng.standard_normal((48, 24)) * 10
        x64 = rng.standard_normal(24)
        tout = tdfe.df_eval(lambda A, x: A @ x, _tdf(A64), _tdf(x64))
        _close_to_jax(jdf_eval(lambda A, x: A @ x, _jsplit(A64),
                               _jsplit(x64)), tout)
        f32err = np.abs((A64.astype(np.float32) @ x64.astype(np.float32))
                        .astype(np.float64) - A64 @ x64).max()
        dferr = np.abs(T.df_value_f64(tout) - A64 @ x64).max()
        assert dferr < 1e-10 and dferr < f32err / 1e4
    elif case == "pow15":
        u = np.array([0.0, 1.0, 4.0], np.float32)
        tout = tdfe.df_eval(lambda v: v ** torch.tensor(1.5, dtype=v.dtype),
                            torch.tensor(u))
        jout = jdf_eval(lambda v: v ** jnp.asarray(1.5, v.dtype),
                        jnp.asarray(u))
        np.testing.assert_allclose(T.df_value_f64(tout), [0.0, 1.0, 8.0],
                                   atol=1e-12)
        _close_to_jax(jout, tout)
    elif case == "transcendentals":
        v = np.abs(u64) + 0.1
        _close_to_jax(
            jdf_eval(lambda x: jnp.exp(x) * jnp.sin(x) - jnp.log(x)
                     + jnp.cos(2.0 * x) + jnp.tan(0.1 * x)
                     + jnp.expm1(0.01 * x) - jnp.log1p(x), _jsplit(v)),
            tdfe.df_eval(lambda x: torch.exp(x) * torch.sin(x)
                         - torch.log(x) + torch.cos(2.0 * x)
                         + torch.tan(0.1 * x) + torch.expm1(0.01 * x)
                         - torch.log1p(x), _tdf(v)))
    else:
        _close_to_jax(
            jdf_eval(lambda x: jnp.where(x > 0.1, x * 3.0, jnp.maximum(
                x, jnp.full_like(x, -0.5))) + jnp.mean(x) + jnp.abs(x),
                _jsplit(u64)),
            tdfe.df_eval(lambda x: torch.where(x > 0.1, x * 3.0,
                                               torch.maximum(
                                                   x, torch.full_like(x, -0.5)))
                         + torch.mean(x) + torch.abs(x), _tdf(u64)))


def test_generic_matches_handwritten_brusselator():
    """The interpreter on ``brusselator_2d`` agrees with the hand-written
    df32 residual away from the forcing disc's edge (the two legitimately
    differ where the disc mask flips), as in the JAX package."""
    N = 16
    U32 = tbru.init_u0(N, torch.float32, device="cpu")
    p64 = np.array([3.4, 1.0, 10.0, 1.0 / (N - 1)], np.float64)
    out = tdfe.df_eval(tbru.brusselator_2d,
                       T.DF(U32, torch.zeros_like(U32)), _tdf(p64))
    got = T.df_value_f64(out)
    hh, hl = tbru.brusselator_2d_df32(U32, torch.zeros_like(U32),
                                      torch.tensor(p64))
    diff = np.abs(got - (hh.double() + hl.double()).numpy())
    agree = diff < 2.0
    assert agree.mean() > 0.99
    assert diff[agree].max() < 1e-9


def test_guidance_custom_rule_and_first_order_overlay():
    with pytest.raises(NotImplementedError, match="register a rule"):
        tdfe.df_eval(lambda u: torch.tanh(u), _tdf(np.ones(4)))

    def exp_rule(node, x):
        x = tdfe._as_df(x)
        h = torch.exp(x.hi)
        return T.DF(h, h * x.lo)

    prev = tdfe._DF_RULES.get(aten.exp)
    tdfe.register_df_rule(aten.exp, exp_rule)
    try:
        out = tdfe.df_eval(lambda u: torch.exp(u) * 2.0,
                           _tdf(np.array([0.5, 1.5])))
        assert np.abs(T.df_value_f64(out) - np.exp([0.5, 1.5]) * 2.0).max() \
            < 1e-6
    finally:
        tdfe._DF_RULES[aten.exp] = prev
    rules = tdfe.first_order_rules()
    x = _tdf(np.array([0.3, -0.7]))
    out = tdfe.df_eval(lambda u: torch.tanh(u) + 1e5 * u, x, rules=rules)
    want = np.tanh(T.df_value_f64(x)) + 1e5 * T.df_value_f64(x)
    assert np.abs(T.df_value_f64(out) - want).max() < 1e-6
    jout = jdf_eval(lambda u: jnp.tanh(u) + 1e5 * u,
                    _jsplit(np.array([0.3, -0.7])),
                    rules=__import__(
                        "nonlinearsolve_tpu.ops.doublef32_eval",
                        fromlist=["first_order_rules"]).first_order_rules())
    assert np.abs(T.df_value_f64(out) - J.df_value_f64(jout)).max() < 1e-6


def test_trace_wide_auto_guard():
    """A residual whose f32 graph rounds a tensor constant keeps the f64
    graph (exact constants); one that introspects its dtype in a tensor
    constant warns and uses the f32 graph; ``trace_wide=False`` is
    silent.  Python scalars are exact either way."""
    u32 = torch.tensor(np.linspace(0.1, 0.2, 16), dtype=torch.float32)
    u64 = u32.double().numpy()
    h = 1.0 / 31.0

    def resid(u):
        c = torch.tensor(0.3, dtype=u.dtype)
        return (u - c) / (h * h) + u * u

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = tdfe.df_eval(resid, T.DF(u32, torch.zeros_like(u32)))
    ref = (u64 - 0.3) / (h * h) + u64 * u64
    assert np.abs(T.df_value_f64(out) - ref).max() < 1e-9
    narrow = tdfe.df_eval(resid, T.DF(u32, torch.zeros_like(u32)),
                          trace_wide=False)
    assert np.abs(T.df_value_f64(narrow) - ref).max() > 1e-6

    def introspect(u):
        return u * u + torch.tensor(torch.finfo(u.dtype).eps, dtype=u.dtype)

    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out2 = tdfe.df_eval(introspect, T.DF(u32, torch.zeros_like(u32)))
    assert any("narrow" in str(w.message) for w in rec)
    ref2 = u64 * u64 + np.finfo(np.float32).eps
    assert np.abs(T.df_value_f64(out2) - ref2).max() < 1e-12
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tdfe.df_eval(introspect, T.DF(u32, torch.zeros_like(u32)),
                     trace_wide=False)
    # the JAX package warns on the same residual (there its scalar eps)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        jdf_eval(lambda u: u * u + jnp.finfo(u.dtype).eps,
                 J.DF(jnp.asarray(u32.numpy()),
                      jnp.zeros(16, jnp.float32)))
    assert any("narrow" in str(w.message) for w in rec)


def test_df_trace_evaluates_one_graph_at_other_points(monkeypatch):
    """``df_trace`` traces once; its graph at another point gives
    ``df_eval``'s words there bit for bit, and ``auto_refine`` traces the
    residual once (the narrow and the wide graph) for all its rounds."""
    def resid(u):
        return torch.exp(u) * u - 1.5 * u * u + torch.roll(u, 1)

    u1 = _tdf(X64[:64] * 0.1)
    u2 = _tdf(X64[64:128] * 0.1)
    graph = tdfe.df_trace(resid, u1)
    got, want = graph(u2), tdfe.df_eval(resid, u2)
    for a, b in ((got.hi, want.hi), (got.lo, want.lo)):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.numpy().view(np.int32))
    from nonlinearsolve_tpu_torch.ops import _graph
    traces = []
    real_trace = _graph.trace
    monkeypatch.setattr(_graph, "trace",
                        lambda *a, **k: traces.append(1) or real_trace(*a,
                                                                        **k))
    b = torch.tensor(np.linspace(0.5, 1.5, 8), dtype=torch.float32)
    prob = tnls.NonlinearProblem(lambda u, p: u ** 3 + u - b,
                                 torch.zeros(8, dtype=torch.float32))
    sol = tnls.solve(prob, tnls.NewtonRaphson(), abstol=1e-4)
    res = tnls.auto_refine(prob, sol.u, rounds=3)
    assert len(traces) == 2 and res.rounds == 3
    assert float(res.defect_norm) < 1e-10


def test_df_eval_pytree_and_integer_pipelines():
    """Arguments as a tuple of DF and a dict; integer index pipelines ride
    through untouched."""
    x = _tdf(np.arange(6.0) * 0.1 + 1.0)
    p = {"a": _tdf(np.array(2.0)), "k": torch.tensor([2, 0, 1])}

    def f(u, q):
        idx = (q["k"] + 1) % 3
        return {"r": u[:3][idx] * q["a"] - u[3:] ** 2}

    out = tdfe.df_eval(f, x, p)["r"]
    xv = T.df_value_f64(x)
    want = xv[:3][(np.array([2, 0, 1]) + 1) % 3] * 2.0 - xv[3:] ** 2
    assert np.abs(T.df_value_f64(out) - want).max() < 1e-14


"""The reverse rules of the SpMV kernels against the JAX package's custom
VJPs, f64 on the CPU (the port's plain versions; the JAX kernels in
interpret mode).

- K5 (``ops/pallas_spmv.py`` ``_ell_spmv_bwd``), K7
  (``pallas_spmv_stream.py`` ``_band_spmv_bwd``) and K8
  (``pallas_spmv_scatter.py`` ``_scatter_spmv_bwd``): the JAX tests'
  patterns (``test_pallas_spmv.py:202``, ``test_pallas_spmv_stream.py:197``,
  ``test_pallas_spmv_scatter.py:80``) through ``SpmvFunction`` on each
  kernel's route: d̄ata and x̄ within rel 1e-12 of ``jax.grad`` (the same
  products, summed in another order).  x̄ runs on Aᵀ's tables; a
  structurally symmetric pattern reuses its own plan.
- ``CSR.matvec`` on every tier of ``test_torch_spmv_stream.py``'s routes
  (the caps lowered on the port's side as there), the RCM-reordered band
  route included, against the exact products; and the route's fallback
  when no plan of its kind fits Aᵀ.
- ``DIA.matvec`` and ``BSR``'s K5 product against the JAX package's
  gradients, and a second derivative through ``CSR.matvec``.
- The grad refusals: where ``jax.grad`` through a JAX kernel raises
  (K1–K4, K6, K9–K11 and K5's unit-data selection), the port's wrapper
  raises and names the kernel; the forward-only K5, K7 and K8 wrappers
  point to ``csr_spmv``.  A forward-mode tangent through ``CSR.matvec``
  or a bare wrapper raises (the JAX package's custom VJPs refuse
  ``jax.jvp``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from nonlinearsolve_tpu.ops import pallas_spmv as jps
from nonlinearsolve_tpu.ops import pallas_spmv_scatter as jsc
from nonlinearsolve_tpu.ops import pallas_spmv_stream as jst
from nonlinearsolve_tpu.ops import pallas_stencil as jstn
from nonlinearsolve_tpu.ops import pallas_stencil3d as jst3
from nonlinearsolve_tpu.ops import sparse as jsparse
from nonlinearsolve_tpu.ops.selection import StaticSelection as JSelection
from nonlinearsolve_tpu_torch.ops import spmv as tps
from nonlinearsolve_tpu_torch.ops import spmv_scatter as tsc
from nonlinearsolve_tpu_torch.ops import spmv_stream as tst
from nonlinearsolve_tpu_torch.ops import stencil as tstn
from nonlinearsolve_tpu_torch.ops import stencil3d as tst3
from nonlinearsolve_tpu_torch.ops.selection import StaticSelection
from nonlinearsolve_tpu_torch.ops.sparse import BSR, CSR, DIA

from test_torch_spmv_stream import (ROUTE_CASES, _rand_data, caps,  # noqa
                                    periodic7)

torch.set_num_threads(2)

RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _t(x):
    return torch.tensor(np.asarray(x), dtype=torch.float64)


def _pattern(A):
    """A SciPy matrix's pattern as a ``CSR`` (what a route reads)."""
    return CSR(None, A.indices, A.indptr, A.shape)


def _port_grads(route, data, x, w, loss="vdot"):
    """d̄ata and x̄ of ⟨w, A·x⟩ (or Σ sin(A·x)) through ``SpmvFunction``."""
    d = _t(data).requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    y = tps.SpmvFunction.apply(d, xt, route)
    out = (_t(w) * y).sum() if loss == "vdot" else torch.sin(y).sum()
    gd, gx = torch.autograd.grad(out, (d, xt))
    return gd.numpy(), gx.numpy()


def _random_csr(rng, n, m, max_per_row):
    """The JAX test's random pattern (``test_pallas_spmv.py``)."""
    rows, cols = [], []
    for i in range(n):
        k = int(rng.integers(1, max_per_row + 1))
        cs = rng.choice(m, size=k, replace=False)
        rows += [i] * k
        cols += list(cs)
    A = sp.coo_matrix((rng.standard_normal(len(rows)), (rows, cols)),
                      shape=(n, m)).tocsr()
    A.sort_indices()
    return A


@pytest.mark.parametrize("n,m", [(256, 256), (300, 200)])
def test_k5_reverse_rule_matches_jax(n, m):
    """x̄ = K5 on Aᵀ's CSR tables (square and rectangular patterns)."""
    rng = np.random.default_rng(13)
    A = _random_csr(rng, n, m, 4)
    x = rng.standard_normal(m)
    w = rng.standard_normal(n)
    plan = jps.ell_plan_for(A.indptr, A.indices, n, m)

    def f(d, xx):
        return jnp.vdot(jnp.asarray(w),
                        jps.ell_spmv_pallas(plan, d, xx, interpret=True))

    jgd, jgx = jax.grad(f, argnums=(0, 1))(jnp.asarray(A.data),
                                           jnp.asarray(x))
    route = tps.SpmvRoute("gather", None, _pattern(A))
    gd, gx = _port_grads(route, A.data, x, w)
    assert _rel(gd, jgd) <= RTOL and _rel(gx, jgx) <= RTOL
    troute, tperm = route.transpose()
    assert troute.kind == "gather" and troute.shape == (m, n)
    np.testing.assert_array_equal(tperm, jps.transpose_pattern_of(
        A.indptr, A.indices, n, m)[2])
    # CSR.matvec takes the same rule on its own tier
    C = CSR(_t(A.data).requires_grad_(True), A.indices, A.indptr, (n, m))
    xt = _t(x).requires_grad_(True)
    gd2, gx2 = torch.autograd.grad((_t(w) * C.matvec(xt)).sum(),
                                   (C.data, xt))
    assert _rel(gd2.numpy(), jgd) <= RTOL and _rel(gx2.numpy(), jgx) <= RTOL


def _band_cases():
    n = 640
    tri = sp.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)],
                   [-1, 0, 1]).tocsr()
    skew = sp.diags([np.ones(n - 2), np.ones(n), np.ones(n - 1)],
                    [-2, 0, 1]).tocsr()
    return {"tridiagonal": tri, "skew-band": skew}


@pytest.mark.parametrize("case", ["tridiagonal", "skew-band"])
def test_k7_reverse_rule_matches_jax(case):
    """x̄ = K7 on Aᵀ's band plan (the JAX test's tridiagonal, whose
    transpose is its own pattern, and a band that is not symmetric)."""
    A = _rand_data(_band_cases()[case], 3)
    n = A.shape[0]
    rng = np.random.default_rng(4)
    x, w = rng.standard_normal(n), rng.standard_normal(n)
    jplan = jst.band_plan_for(A.indptr, A.indices, n, n)

    def f(d, xx):
        return jnp.vdot(jnp.asarray(w),
                        jst.band_spmv_pallas(jplan, d, xx, interpret=True))

    jgd, jgx = jax.grad(f, argnums=(0, 1))(jnp.asarray(A.data),
                                           jnp.asarray(x))
    plan = tst.band_plan_for(A.indptr, A.indices, n, n)
    assert plan.supported
    route = tps.SpmvRoute("stream", plan, _pattern(A))
    gd, gx = _port_grads(route, A.data, x, w)
    assert _rel(gd, jgd) <= RTOL and _rel(gx, jgx) <= RTOL
    troute = route.transpose()[0]
    assert troute.kind == "stream" and troute.plan.supported
    assert (troute.plan is plan) == (case == "tridiagonal")


def test_k8_reverse_rule_matches_jax():
    """x̄ = K8 on Aᵀ's scatter plan (the JAX test's 600² pattern, the
    loss Σ sin(A·x))."""
    r = np.random.default_rng(6)
    rows = np.repeat(np.arange(600), 6)
    A = sp.coo_matrix((r.standard_normal(rows.size),
                       (rows, r.integers(0, 600, size=rows.size))),
                      shape=(600, 600)).tocsr()
    A.sum_duplicates()
    x = np.random.default_rng(2).standard_normal(600)
    jplan = jsc.ScatterPlan(A.indptr, A.indices, *A.shape)

    def f(d, xx):
        return jnp.sum(jnp.sin(jsc.scatter_spmv_pallas(jplan, d, xx,
                                                       interpret=True)))

    jgd, jgx = jax.grad(f, argnums=(0, 1))(jnp.asarray(A.data),
                                           jnp.asarray(x))
    plan = tsc.scatter_plan_for(A.indptr, A.indices, *A.shape)
    route = tps.SpmvRoute("scatter", plan, _pattern(A))
    gd, gx = _port_grads(route, A.data, x, None, loss="sin")
    assert _rel(gd, jgd) <= RTOL and _rel(gx, jgx) <= RTOL
    troute = route.transpose()[0]
    assert troute.kind == "scatter" and troute.plan.supported


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_csr_matvec_reverse_rule_on_every_tier(case, caps):  # noqa: F811
    """d̄ata = ȳ[row]·x[col] and x̄ = Aᵀȳ through ``CSR.matvec`` on each
    tier, the RCM-reordered band route through its permutations."""
    build, cap_values, tier, reordered = ROUTE_CASES[case]
    caps(**cap_values)
    A = _rand_data(build(), 9)
    C = CSR(_t(A.data).requires_grad_(True), A.indices, A.indptr, A.shape)
    assert C.tier[0] == tier
    route, reord = tps.csr_route(C)
    assert reord == reordered
    rng = np.random.default_rng(10)
    x, w = rng.standard_normal(A.shape[1]), rng.standard_normal(A.shape[0])
    xt = _t(x).requires_grad_(True)
    y = C.matvec(xt)
    assert _rel(y.detach().numpy(), A @ x) <= RTOL
    gd, gx = torch.autograd.grad((_t(w) * y).sum(), (C.data, xt))
    rows = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    assert _rel(gd.numpy(), w[rows] * x[A.indices]) <= RTOL
    assert _rel(gx.numpy(), A.T @ w) <= RTOL
    assert route.transpose()[0].kind == ("gather" if tier in
                                         ("resident", None) else tier)


def test_symmetric_pattern_reuses_its_plan(caps):  # noqa: F811
    """The periodic 7-point pattern (the 256³ band route's structure, here
    at 16³) is its own transpose: x̄ runs on the forward plan itself."""
    caps(DIA_MAX_TABLE=50_000, MAX_X_ELEMS_VMEM=2048)
    indptr, indices = periodic7(16)
    n = 16 ** 3
    A = _rand_data(sp.csr_matrix((np.ones(len(indices)), indices, indptr),
                                 shape=(n, n)), 5)
    C = CSR(_t(A.data), A.indices, A.indptr, A.shape)
    assert C.tier[0] == "stream"
    route, _ = tps.csr_route(C)
    troute, tperm = route.transpose()
    assert troute.plan is route.plan
    w = np.random.default_rng(1).standard_normal(n)
    xt = _t(np.ones(n)).requires_grad_(True)
    gx, = torch.autograd.grad((_t(w) * C.matvec(xt)).sum(), xt)
    assert _rel(gx.numpy(), A.T @ w) <= RTOL


def test_unsupported_transpose_takes_segment_sum(monkeypatch):
    """When no band plan fits Aᵀ, x̄ takes the JAX package's segment-sum
    route (a rule on the pattern, decided once)."""
    A = _rand_data(_band_cases()["skew-band"], 8)
    n = A.shape[0]
    plan = tst.band_plan_for(A.indptr, A.indices, n, n)
    route = tps.SpmvRoute("stream", plan, _pattern(A))

    class _Unsupported:
        supported = False

    monkeypatch.setattr(tst, "band_plan_for", lambda *a: _Unsupported())
    rng = np.random.default_rng(2)
    x, w = rng.standard_normal(n), rng.standard_normal(n)
    gd, gx = _port_grads(route, A.data, x, w)
    assert route.transpose()[0].kind == "segment_sum"
    assert _rel(gx, A.T @ w) <= RTOL


def test_dia_matvec_gradient_matches_jax():
    """``DIA.matvec`` (K4 forward, K4 on Aᵀ's diagonals backward) against
    the JAX package's ``DIA.matvec`` under ``jax.grad``."""
    n = 50
    rng = np.random.default_rng(3)
    A = sp.diags([rng.standard_normal(n - 3), rng.standard_normal(n),
                  rng.standard_normal(n - 1)], [-3, 0, 1]).tocsr()
    jd = jsparse.DIA.from_csr(jsparse.CSR(jnp.asarray(A.data), A.indices,
                                          A.indptr, A.shape))
    td = DIA.from_csr(CSR(_t(A.data), A.indices, A.indptr, A.shape))
    x, w = rng.standard_normal(n), rng.standard_normal(n)

    def f(dd, xx):
        return jnp.vdot(jnp.asarray(w), jsparse.DIA(dd, jd.offsets,
                                                    jd.shape).matvec(xx))

    jgd, jgx = jax.grad(f, argnums=(0, 1))(jd.data, jnp.asarray(x))
    dd = td.data.clone().requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    y = DIA(dd, td.offsets, td.shape).matvec(xt)
    gd, gx = torch.autograd.grad((_t(w) * y).sum(), (dd, xt))
    assert _rel(gx.numpy(), jgx) <= RTOL
    # the pad slots (outside the matrix) carry no gradient in either
    valid = np.asarray(jgd) != 0
    assert _rel(gd.numpy()[valid], np.asarray(jgd)[valid]) <= RTOL
    assert not gd.numpy()[~valid].any()


def test_bsr_k5_product_gradient_matches_jax():
    """The card's BSR product (K5 on the expanded scalar pattern) against
    the JAX package's ``bsr_spmv_pallas`` under ``jax.grad``."""
    rng = np.random.default_rng(5)
    A = _random_csr(rng, 64, 64, 5)
    jb = jsparse.BSR.from_csr(jsparse.CSR(jnp.asarray(A.data), A.indices,
                                          A.indptr, A.shape), 2)
    tb = BSR.from_csr(CSR(_t(A.data), A.indices, A.indptr, A.shape), 2)
    x, w = rng.standard_normal(64), rng.standard_normal(64)

    def f(data, xx):
        return jnp.vdot(jnp.asarray(w), jps.bsr_spmv_pallas(
            jb.with_data(data), xx, interpret=True))

    jgd, jgx = jax.grad(f, argnums=(0, 1))(jb.data, jnp.asarray(x))
    data = tb.data.clone().requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    y = tps.bsr_spmv(tb.with_data(data), xt)
    gd, gx = torch.autograd.grad((_t(w) * y).sum(), (data, xt))
    assert _rel(gd.numpy(), jgd) <= RTOL and _rel(gx.numpy(), jgx) <= RTOL


def test_second_derivative_through_csr_matvec():
    """x̄ goes through the same Function, so a Hessian-vector product of
    Σ sin(A·x) comes out (the port's rule is differentiable again)."""
    rng = np.random.default_rng(7)
    A = _random_csr(rng, 80, 80, 4)
    C = CSR(_t(A.data), A.indices, A.indptr, A.shape)
    x = _t(rng.standard_normal(80)).requires_grad_(True)
    v = _t(rng.standard_normal(80))
    g, = torch.autograd.grad(torch.sin(C.matvec(x)).sum(), x,
                             create_graph=True)
    hv, = torch.autograd.grad((g * v).sum(), x)
    D = _t(A.toarray())
    ref = D.T @ (-torch.sin(D @ x.detach()) * (D @ v))
    assert _rel(hv.numpy(), ref.numpy()) <= RTOL


def _jax_k1(U, T, p):
    return jstn.brusselator_jvp(U, T, p)


def _refusal_cases():
    """(name, JAX call under grad, port call under grad, kernel named)."""
    rng = np.random.default_rng(0)
    N = 8
    U = rng.random((N, N, 2))
    p = np.array([3.4, 1.0, 10.0, 1.0 / N])
    u3 = rng.random((8, 8, 8))
    dd = np.ones((3, 16))
    x16 = np.arange(16.0)
    A = _random_csr(rng, 16, 16, 3)

    def jbsr(X):
        jb = jsparse.BSR.from_csr(jsparse.CSR(jnp.asarray(A.data),
                                              A.indices, A.indptr,
                                              A.shape), 2)
        return jps.bsr_spmm_pallas(jb, X, interpret=True)

    def tbsr(X):
        tb = BSR.from_csr(CSR(_t(A.data), A.indices, A.indptr, A.shape), 2)
        return tps.bsr_spmm(tb, X)

    src = np.array([0, 3, 16, 5])
    return {
        "K1": (lambda t: _jax_k1(jnp.asarray(U), t, jnp.asarray(p)),
               lambda t: tstn.brusselator_jvp(_t(U), t, _t(p)),
               np.ones((N, N, 2)), "K1 brusselator_jvp"),
        "K2": (lambda t: jstn.brusselator_jvp_scaled(
                   jnp.asarray(U), t, jnp.asarray(p), 1.0)[0],
               lambda t: tstn.brusselator_jvp_scaled(_t(U), t, _t(p),
                                                     1.0)[0],
               np.ones((N, N, 2)), "K2 brusselator_jvp_scaled"),
        "K3": (lambda t: jstn.make_brusselator_jvp_bf16(
                   jnp.asarray(U, jnp.float32),
                   jnp.asarray(p, jnp.float32))(t.astype(jnp.float32)),
               lambda t: tstn.make_brusselator_jvp_bf16(
                   _t(U).float(), _t(p).float())(t.float()),
               np.ones((N, N, 2)), "K3 brusselator_jvp_bf16"),
        "K4": (lambda x: jstn.dia_spmv_pallas(jnp.asarray(dd), (-1, 0, 1),
                                              x),
               lambda x: tps.dia_spmv(_t(dd), (-1, 0, 1), x), x16,
               "K4 dia_spmv"),
        "K5-selection": (
            lambda v: JSelection(src, 16).apply(v, force=True),
            lambda v: StaticSelection(src, 16).apply(v), x16,
            "K5 gather_select"),
        "K6": (jbsr, tbsr, np.ones((16, 3)), "K6 bsr_spmm"),
        "K9": (lambda t: jst3.rd3d_jvp_blocked(jnp.asarray(u3), t, 0.01,
                                               bz=4),
               lambda t: tst3.rd3d_jvp_blocked(_t(u3), t, 0.01, bz=4),
               np.ones((8, 8, 8)), "K9 rd3d_jvp_blocked"),
        "K10": (lambda t: jst3.rd3d_jvp_scaled(jnp.asarray(u3), t, 0.01,
                                               1.0, bz=4)[0],
                lambda t: tst3.rd3d_jvp_scaled(_t(u3), t, 0.01, 1.0,
                                               bz=4)[0],
                np.ones((8, 8, 8)), "K10 rd3d_jvp_scaled"),
        "K11": (lambda t: jst3.rd3d_jvp_blocked_halo(
                    jnp.asarray(u3), t, jnp.ones((1, 8, 8)),
                    jnp.ones((1, 8, 8)), 0.01, bz=4),
                lambda t: tst3.rd3d_jvp_blocked_halo(
                    _t(u3), t, torch.ones((1, 8, 8), dtype=torch.float64),
                    torch.ones((1, 8, 8), dtype=torch.float64), 0.01, bz=4),
                np.ones((8, 8, 8)), "K11 rd3d_jvp_blocked_halo"),
    }


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5-selection",
                                    "K6", "K9", "K10", "K11"])
def test_grad_refusals_equal_jax(kernel):
    """``jax.grad`` through the JAX kernel raises; so does the port's
    wrapper under grad, naming the kernel.  Without grad it runs."""
    jcall, tcall, arg, name = _refusal_cases()[kernel]
    with pytest.raises(Exception):
        jax.grad(lambda a: jnp.sum(jcall(a)).astype(jnp.float32))(
            jnp.asarray(arg))
    a = _t(arg).requires_grad_(True)
    with pytest.raises(NotImplementedError, match=name):
        tcall(a)
    with torch.no_grad():
        assert torch.isfinite(tcall(a).float()).all()


def test_forward_only_wrappers_point_to_csr_spmv():
    """The bare K5, K7 and K8 wrappers refuse grad and name the entry that
    carries their reverse rule."""
    A = _rand_data(_band_cases()["tridiagonal"], 1)
    n = A.shape[0]
    x = _t(np.ones(n)).requires_grad_(True)
    indptr = torch.tensor(A.indptr, dtype=torch.int32)
    indices = torch.tensor(A.indices, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="K5 gather_spmv.*csr_spmv"):
        tps.gather_spmv(indptr, indices, _t(A.data), x)
    plan = tst.band_plan_for(A.indptr, A.indices, n, n)
    with pytest.raises(NotImplementedError, match="K7 band_spmv.*csr_spmv"):
        tst.band_spmv(plan, _t(A.data), x)
    splan = tsc.scatter_plan_for(A.indptr, A.indices, n, n)
    with pytest.raises(NotImplementedError,
                       match="K8 scatter_spmv_part.*csr_spmv"):
        tsc.scatter_spmv(splan, _t(A.data), x)


@pytest.mark.parametrize("entry", ["csr_matvec", "gather_spmv", "K1", "K4",
                                   "dia_matvec"])
def test_forward_mode_tangents_are_refused(entry):
    """No kernel has a forward-mode rule (the JAX package's custom VJPs
    refuse ``jax.jvp``): a tangent through ``CSR.matvec``, ``DIA.matvec``
    or a bare wrapper raises, under ``forward_ad`` and ``torch.func.jvp`` alike,
    rather than come back without its tangent."""
    from torch.autograd import forward_ad
    rng = np.random.default_rng(11)
    A = _random_csr(rng, 32, 32, 3)
    C = CSR(_t(A.data), A.indices, A.indptr, A.shape)
    N = 8
    U = _t(rng.random((N, N, 2)))
    p = _t([3.4, 1.0, 10.0, 1.0 / N])
    calls = {
        "csr_matvec": (C.matvec, 32, "csr_spmv"),
        "gather_spmv": (lambda x: tps.gather_spmv(
            torch.tensor(A.indptr, dtype=torch.int32),
            torch.tensor(A.indices, dtype=torch.int32), C.data, x), 32,
            "K5 gather_spmv"),
        "K1": (lambda t: tstn.brusselator_jvp(U, t, p), (N, N, 2),
               "K1 brusselator_jvp"),
        "K4": (lambda x: tps.dia_spmv(_t(np.ones((3, 32))), (-1, 0, 1), x),
               32, "K4 dia_spmv"),
        "dia_matvec": (DIA(_t(np.ones((3, 32))), (-1, 0, 1), (32, 32)).matvec,
                       32, "K4 dia_spmv"),
    }
    f, shape, name = calls[entry]
    x = _t(rng.standard_normal(shape))
    with forward_ad.dual_level():
        with pytest.raises(NotImplementedError,
                           match=f"{name}.*no forward-mode rule"):
            f(forward_ad.make_dual(x, torch.ones_like(x)))
    with pytest.raises(NotImplementedError, match="no forward-mode rule"):
        torch.func.jvp(f, (x,), (torch.ones_like(x),))
    assert torch.isfinite(f(x)).all()

"""The port's sparse layer against the JAX package, on the same seeded numpy
inputs (f64 unless stated): the containers (``ops/sparse.py``), the plain
versions of kernels K4 and K5 (``ops/spmv.py``), the static selection, the
patterns, the coloring, the DIA plan and the colored Jacobian.

Tolerances: the containers at rtol 1e-12 (f64) and 1e-5 (f32), since sums
are taken in another order; the plain K5 and K4 against the Pallas kernels
in interpret mode at 1e-12 (n ≤ 2048); selections, patterns, colors and offsets
exactly; the colored Jacobian's data at atol 1e-13 (entries up to
4α/h² = 9000 at N=16, where an ulp is 1.8e-12, agree to the last bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.ops import coloring as jcol
from nonlinearsolve_tpu.ops import pallas_spmv as jps
from nonlinearsolve_tpu.ops import sparse as jsp
from nonlinearsolve_tpu.ops import spmv_dia as jdia
from nonlinearsolve_tpu.ops.pallas_stencil import dia_spmv_pallas
from nonlinearsolve_tpu.ops.selection import StaticSelection as JSel
from nonlinearsolve_tpu.ops.sparse_jac import ColoredJacobian as JCJ
from nonlinearsolve_tpu_torch import _backend, native
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.ops import coloring as tcol
from nonlinearsolve_tpu_torch.ops import sparse as tsp
from nonlinearsolve_tpu_torch.ops import spmv as tspmv
from nonlinearsolve_tpu_torch.ops import spmv_dia as tdia
from nonlinearsolve_tpu_torch.ops.selection import StaticSelection as TSel
from nonlinearsolve_tpu_torch.ops.sparse_jac import (ColoredJacobian as TCJ,
                                                     plan_sparse_jacobian)

torch.set_num_threads(2)

RTOL = {"float64": 1e-12, "float32": 1e-5}
NP_DT = {"float64": np.float64, "float32": np.float32}


def _random_coo(rng, n, m, max_per_row):
    rows, cols = [], []
    for i in range(n):
        k = int(rng.integers(1, max_per_row + 1))
        rows += [i] * k
        cols += list(rng.choice(m, size=k, replace=False))
    return np.array(rows), np.array(cols)


def _pair(rows, cols, shape, data):
    """The same CSR in both packages (the JAX one sorts with the data)."""
    j = jsp.CSR.from_pattern(rows, cols, shape, data=jnp.asarray(data))
    t = tsp.CSR.from_pattern(rows, cols, shape, data=torch.tensor(data))
    return j, t


def _close(got, ref, rtol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= rtol * scale


def _flat_residual(N):
    def f(u, p):
        return tbru.brusselator_2d(u.reshape(N, N, 2), p).reshape(-1)
    return f


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["rect", "square", "brusselator"])
def test_csr_equals_jax(case, dtype):
    rng = np.random.default_rng(7)
    if case == "rect":
        rows, cols = _random_coo(rng, 300, 250, 8)
        shape = (300, 250)
    elif case == "square":
        rows, cols = _random_coo(rng, 400, 400, 6)
        shape = (400, 400)
    else:
        pat = jbru.sparsity_pattern(8)
        rows, cols = pat.row_ids, pat.indices
        shape = pat.shape
    data = rng.standard_normal(len(rows)).astype(NP_DT[dtype])
    x = rng.standard_normal(shape[1]).astype(NP_DT[dtype])
    J, T = _pair(rows, cols, shape, data)
    np.testing.assert_array_equal(T.indptr, J.indptr)
    np.testing.assert_array_equal(T.indices, J.indices)
    np.testing.assert_array_equal(T.data.numpy(), np.asarray(J.data))
    ref = np.asarray(J.matvec(jnp.asarray(x)))
    _close(T.matvec(torch.tensor(x)).numpy(), ref, RTOL[dtype])
    _close(T.matvec_fn()(torch.tensor(x)).numpy(),
           np.asarray(J.matvec_fn()(jnp.asarray(x))), RTOL[dtype])
    np.testing.assert_array_equal(T.todense().numpy(),
                                  np.asarray(J.todense()))
    if shape[0] == shape[1]:
        np.testing.assert_array_equal(T.diagonal().numpy(),
                                      np.asarray(J.diagonal()))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dia_equals_jax(dtype):
    rng = np.random.default_rng(3)
    pat = jbru.sparsity_pattern(8)
    data = rng.standard_normal(pat.nnz).astype(NP_DT[dtype])
    jd = jsp.DIA.from_csr(pat.with_data(jnp.asarray(data)))
    td = tsp.DIA(torch.tensor(np.asarray(jd.data)), jd.offsets, jd.shape)
    x = rng.standard_normal(pat.shape[0]).astype(NP_DT[dtype])
    _close(td.matvec(torch.tensor(x)).numpy(),
           np.asarray(jd.matvec(jnp.asarray(x))), RTOL[dtype])
    _close(td.rmatvec(torch.tensor(x)).numpy(),
           np.asarray(jd.rmatvec(jnp.asarray(x))), RTOL[dtype])
    np.testing.assert_array_equal(td.diagonal().numpy(),
                                  np.asarray(jd.diagonal()))
    np.testing.assert_array_equal(td.todense().numpy(),
                                  np.asarray(jd.todense()))
    assert td.nnz == jd.nnz


def test_dia_with_inf_in_pad_slots_gives_finite_y():
    """K4 (here its plain version) never reads a slot whose column falls
    outside [0, n), so inf and NaN there cannot reach y."""
    rng = np.random.default_rng(4)
    n = 64
    offsets = (-5, -1, 0, 2, 7)
    dd = torch.tensor(rng.standard_normal((len(offsets), n)))
    for d, off in enumerate(offsets):
        if off > 0:
            dd[d, n - off:] = float("inf")
        elif off < 0:
            dd[d, :-off] = float("nan")
    x = torch.tensor(rng.standard_normal(n))
    y = tsp.DIA(dd, offsets, (n, n)).matvec(x)
    assert torch.isfinite(y).all()
    clean = dd.clone()
    clean[~torch.isfinite(clean)] = 0.0
    np.testing.assert_array_equal(y.numpy(),
                                  tspmv.dia_spmv_plain(clean, offsets,
                                                       x).numpy())


# ---------------------------------------------------------------------------
# plain kernels against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,w", [(300, 300, 8), (1025, 1025, 3), (8, 8, 2),
                                   (640, 500, 12)])
def test_plain_k5_equals_ell_spmv_pallas(n, m, w):
    rng = np.random.default_rng(n)
    rows, cols = _random_coo(rng, n, m, w)
    data = rng.standard_normal(len(rows))
    J, T = _pair(rows, cols, (n, m), data)
    x = rng.standard_normal(m)
    plan = jps.ell_plan_for(J.indptr, J.indices, n, m)
    ref = np.asarray(jps.ell_spmv_pallas(plan, J.data, jnp.asarray(x),
                                         interpret=True))
    indptr, indices = T.device_tables("cpu")
    got = tspmv.gather_spmv(indptr, indices, T.data, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("offsets", [(-3, 0, 1), (-9, -1, 0, 1, 2, 9)])
def test_plain_k4_equals_dia_spmv_pallas(offsets):
    rng = np.random.default_rng(len(offsets))
    n = 128
    A = np.zeros((n, n))
    for off in offsets:
        A += np.diag(rng.standard_normal(n - abs(off)), off)
    jd = jsp.DIA.from_csr(jsp.CSR.from_dense(A))
    assert jd.offsets == offsets
    x = rng.standard_normal(n)
    ref = np.asarray(dia_spmv_pallas(jd.data, jd.offsets, jnp.asarray(x)))
    got = tspmv.dia_spmv(torch.tensor(np.asarray(jd.data)), jd.offsets,
                         torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got.numpy(), A @ x, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_static_selection_equals_jax_bitwise(dtype):
    rng = np.random.default_rng(11)
    n_src = 500
    src = rng.integers(0, n_src + 1, size=1200)     # n_src entries are pads
    src[:5] = n_src
    values = rng.standard_normal(n_src).astype(NP_DT[dtype])
    ref = np.asarray(JSel(src, n_src).apply(jnp.asarray(values)))
    got = TSel(src, n_src).apply(torch.tensor(values)).numpy()
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    assert not got[:5].any()


def test_cpu_path_counts_no_launch():
    rng = np.random.default_rng(0)
    pat = tbru.sparsity_pattern(4)
    A = pat.with_data(torch.tensor(rng.standard_normal(pat.nnz)))
    x = torch.tensor(rng.standard_normal(pat.shape[0]))
    before = dict(_backend.LAUNCHES)
    A.matvec(x)
    A.matvec_fn()(x)
    TSel(np.array([0, 3, 5]), 5).apply(torch.ones(5, dtype=torch.float64))
    assert _backend.LAUNCHES == before


# ---------------------------------------------------------------------------
# patterns, coloring, plans
# ---------------------------------------------------------------------------

def test_sparsity_pattern_equals_jax():
    j, t = jbru.sparsity_pattern(16), tbru.sparsity_pattern(16)
    assert t.shape == j.shape == (512, 512)
    np.testing.assert_array_equal(t.indptr, j.indptr)
    np.testing.assert_array_equal(t.indices, j.indices)
    assert t.nnz == 12 * 16 * 16


@pytest.mark.parametrize("form", ["csr", "coo", "dense_numpy", "dense_torch"])
def test_pattern_from_equals_jax(form):
    rng = np.random.default_rng(5)
    rows, cols = _random_coo(rng, 40, 30, 4)
    mask = np.zeros((40, 30))
    mask[rows, cols] = 1.0
    jpat = jcol.pattern_from(mask, 40, 30)
    spec = {"csr": tsp.CSR.from_pattern(rows, cols, (40, 30)),
            "coo": (rows, cols), "dense_numpy": mask,
            "dense_torch": torch.tensor(mask)}[form]
    tpat = tcol.pattern_from(spec, 40, 30)
    np.testing.assert_array_equal(tpat.indptr, jpat.indptr)
    np.testing.assert_array_equal(tpat.indices, jpat.indices)


def test_pattern_from_refuses_bad_specs():
    with pytest.raises(ValueError, match="out of range"):
        tcol.pattern_from((np.array([0, 5]), np.array([0, 1])), 4, 4)
    with pytest.raises(ValueError, match="does not match"):
        tcol.pattern_from(np.ones((3, 4)), 4, 4)


@pytest.mark.parametrize("route", ["native", "python"])
@pytest.mark.parametrize("case", ["brusselator", "random"])
def test_coloring_equals_jax(route, case):
    if case == "brusselator":
        jpat, tpat = jbru.sparsity_pattern(16), tbru.sparsity_pattern(16)
    else:
        rows, cols = _random_coo(np.random.default_rng(9), 200, 200, 5)
        jpat = jsp.CSR.from_pattern(rows, cols, (200, 200))
        tpat = tsp.CSR.from_pattern(rows, cols, (200, 200))
    ref = jcol.greedy_column_coloring(jpat)
    got = (tcol.greedy_column_coloring(tpat) if route == "native"
           else tcol.greedy_column_coloring_py(tpat))
    np.testing.assert_array_equal(got, ref)
    if case == "brusselator":
        assert got.max() + 1 == 8


def test_native_coloring_refuses_malformed_pattern():
    with pytest.raises(ValueError, match="out of range"):
        native.greedy_column_coloring(np.array([0, 1]), np.array([3]), 1, 2)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A toolkit that does not build raises with the compiler's output;
    nothing falls back to the Python coloring."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", tmp_path / "broken.cpp")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(_backend, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.greedy_column_coloring(np.array([0, 1]), np.array([0]), 1, 1)
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("N", [16, 512])
def test_dia_plan_equals_jax(N):
    """At N=512 the plan is the offsets alone (no data, no selection)."""
    jpat = jbru.sparsity_pattern(N)
    tpat = tbru.sparsity_pattern(N)
    jplan = jdia.DiaPlan(jpat.indptr, jpat.indices, *jpat.shape)
    tier, tplan, perm, _, _ = tspmv.select_spmv_plan(
        tpat.indptr, tpat.indices, *tpat.shape)
    assert tier == "dia" and perm is None
    assert tplan.supported and jplan.supported
    assert tplan.offsets == jplan.offsets
    assert tplan.ndiag == jplan.ndiag == 11
    assert tspmv.select_spmv_plan(tpat.indptr, tpat.indices,
                                  *tpat.shape)[1] is tplan
    if N == 16:
        np.testing.assert_array_equal(tplan.sel.src, jplan.sel.src)
        data = np.random.default_rng(2).standard_normal(tpat.nnz)
        np.testing.assert_array_equal(
            tplan.pack(torch.tensor(data)).numpy(),
            np.asarray(jplan.pack(jnp.asarray(data))))


def test_select_spmv_plan_refuses_wide_patterns():
    """More than 48 generalised diagonals: not the DIA tier, but the JAX
    package's "resident" tier, which the port runs on K5."""
    rows, cols = _random_coo(np.random.default_rng(1), 300, 300, 6)
    pat = tsp.CSR.from_pattern(rows, cols, (300, 300))
    tier, plan, perm, _, _ = tspmv.select_spmv_plan(pat.indptr, pat.indices,
                                                    300, 300)
    jtier, jplan, jperm, _, _ = jps.select_spmv_plan(pat.indptr, pat.indices,
                                                     300, 300)
    assert tier == jtier == "resident" and perm is None and jperm is None
    assert (plan.w, plan.W, plan.mode) == (jplan.w, jplan.W, jplan.mode)
    assert not tdia.DiaPlan(pat.indptr, pat.indices, 300, 300).supported


@pytest.mark.parametrize("wide", [False, True])
def test_tier_is_kept_on_the_pattern(wide, monkeypatch):
    """The tier is worked out once per pattern: copies made by
    ``with_data`` share it, and their products hash nothing again."""
    if wide:
        rows, cols = _random_coo(np.random.default_rng(1), 300, 300, 6)
        pat = tsp.CSR.from_pattern(rows, cols, (300, 300))
    else:
        pat = tbru.sparsity_pattern(8)
    tier = pat.tier
    assert tier[0] == ("resident" if wide else "dia")

    def no_hash(*_):
        raise AssertionError("pattern hashed again")
    monkeypatch.setattr(tspmv, "pattern_key", no_hash)
    rng = np.random.default_rng(3)
    A = pat.with_data(torch.tensor(rng.standard_normal(pat.nnz)))
    x = torch.tensor(rng.standard_normal(pat.shape[1]))
    assert A.tier is tier
    dense = A.todense() @ x
    for _ in range(2):
        _close(A.matvec_fn()(x), dense, 1e-12)
        _close(A.matvec(x), dense, 1e-12)


def test_colored_jacobian_equals_jax():
    """CSR data (``plan(f, u)``) and DIA data (``plan.dia(f, u)``) of the
    flat Brusselator at N=16, at a seeded state near u0."""
    N = 16
    rng = np.random.default_rng(6)
    u = (np.asarray(jbru.init_u0(N)).reshape(-1)
         + 0.1 * rng.standard_normal(2 * N * N))
    jpat = jbru.sparsity_pattern(N)
    jplan = JCJ(jpat, jcol.greedy_column_coloring(jpat))
    jp = jbru.default_p(N)

    def jf(v):
        return jbru.brusselator_2d(v.reshape(N, N, 2), jp).reshape(-1)

    tp = tbru.default_p(N, device="cpu")
    tplan = plan_sparse_jacobian(lambda v: _flat_residual(N)(v, tp),
                                 2 * N * N, 2 * N * N,
                                 sparsity=tbru.sparsity_pattern(N))
    assert isinstance(tplan, TCJ) and tplan.n_colors == jplan.n_colors == 8
    np.testing.assert_array_equal(tplan.colors, jplan.colors)
    tf = (lambda v: _flat_residual(N)(v, tp))
    ref = np.asarray(jplan(jf, jnp.asarray(u)).data)
    got = tplan(tf, torch.tensor(u)).data.numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-13)
    jd = jplan.dia(jf, jnp.asarray(u))
    td = tplan.dia(tf, torch.tensor(u))
    assert td.offsets == jd.offsets
    np.testing.assert_allclose(td.data.numpy(), np.asarray(jd.data), rtol=0,
                               atol=1e-13)


def test_colored_jacobian_equals_dense_jacobian():
    """The assembled J equals torch.func.jacfwd's dense Jacobian."""
    N = 6
    tp = tbru.default_p(N, device="cpu")
    u = tbru.init_u0(N, device="cpu").reshape(-1) + 0.05
    f = (lambda v: _flat_residual(N)(v, tp))
    plan = plan_sparse_jacobian(f, 2 * N * N, 2 * N * N,
                                sparsity=tbru.sparsity_pattern(N))
    dense = torch.func.jacfwd(f)(u)
    torch.testing.assert_close(plan(f, u).todense(), dense, rtol=0,
                               atol=1e-12)
    torch.testing.assert_close(plan.dia(f, u).todense(), dense, rtol=0,
                               atol=1e-12)


def test_sparse_plan_without_pattern_names_a25():
    """Without a pattern the plan detects it (ROADMAP A.25): the
    pattern and coloring of the JAX package's plan."""
    from nonlinearsolve_tpu.ops.sparse_jac import \
        plan_sparse_jacobian as jplan_sparse_jacobian
    N = 6
    jp = jbru.default_p(N)
    tp = tbru.default_p(N, device="cpu")
    jplan = jplan_sparse_jacobian(
        lambda v: jbru.brusselator_2d(v.reshape(N, N, 2), jp).reshape(-1),
        2 * N * N, 2 * N * N)
    tplan = plan_sparse_jacobian(lambda v: _flat_residual(N)(v, tp),
                                 2 * N * N, 2 * N * N, device="cpu")
    np.testing.assert_array_equal(tplan.pattern.indptr, jplan.pattern.indptr)
    np.testing.assert_array_equal(tplan.pattern.indices,
                                  jplan.pattern.indices)
    np.testing.assert_array_equal(tplan.colors, jplan.colors)

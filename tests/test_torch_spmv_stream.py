"""The port's SpMV tier selection and its band tier (kernel K7's plain
version, ``ops/spmv_stream.py``) against the JAX package, on the CPU (f64).

- Tier selection: the port's ``select_spmv_plan`` returns the JAX
  package's tier and reorder on the JAX package's own cases and on the
  3D periodic 7-point pattern at 40³ with the caps lowered on both sides
  (the structure of the 256³ band route: w 11, 5 bands, F 124, cost 0.3465
  a nonzero against the 0.35 scatter threshold).  Plans are compared field
  by field: the tier's costs are floats, and they must agree to the bit.
- K7: ``band_spmv`` (the plain version on the CPU) against
  ``band_spmv_pallas`` in interpret mode on the JAX stream tests' patterns,
  rel-inf 1e-13 (the same products, summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.ops import pallas_spmv as jps
from nonlinearsolve_tpu.ops import pallas_spmv_scatter as jsc
from nonlinearsolve_tpu.ops import pallas_spmv_stream as jst
from nonlinearsolve_tpu.ops import spmv_dia as jdia
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.ops import spmv as tps
from nonlinearsolve_tpu_torch.ops import spmv_dia as tdia
from nonlinearsolve_tpu_torch.ops import spmv_stream as tst

torch.set_num_threads(2)

JAX_CACHES = (jps._TIER_CACHE, jps._REORDER_CACHE, jps._RCM_PATTERN_CACHE,
              jps._PLAN_CACHE, jdia._DIA_PLAN_CACHE, jst._BAND_PLAN_CACHE,
              jsc._SCATTER_PLAN_CACHE)


@pytest.fixture
def caps(monkeypatch):
    """Set a cap on both sides (``set_caps(MAX_X_ELEMS_VMEM=...)``), with
    every plan cache of both packages empty before and after."""
    def clear():
        for cache in JAX_CACHES:
            cache.clear()
        tps.clear_plan_caches()

    def set_caps(**kw):
        for name, value in kw.items():
            mods = (jdia, tdia) if name.startswith("DIA_") else (jps, tps)
            for mod in mods:
                monkeypatch.setattr(mod, name, value)
    clear()
    yield set_caps
    clear()


def periodic7(N):
    """The 3D periodic 7-point pattern on N³ (C order), columns sorted."""
    n = N ** 3
    i = np.arange(n)
    x, y, z = i // (N * N), (i // N) % N, i % N

    def idx(a, b, c):
        return ((a % N) * N + (b % N)) * N + (c % N)
    cols = np.stack([idx(x - 1, y, z), idx(x, y - 1, z), idx(x, y, z - 1), i,
                     idx(x, y, z + 1), idx(x, y + 1, z), idx(x + 1, y, z)], 1)
    cols.sort(axis=1)
    return np.arange(n + 1) * 7, cols.reshape(-1)


def _tridiag(n):
    return sp.diags([np.ones(n - 1), np.ones(n), np.ones(n - 1)],
                    [-1, 0, 1]).tocsr()


def _permuted(A, seed):
    s = np.random.default_rng(seed).permutation(A.shape[0])
    B = A[s][:, s].tocsr()
    B.sort_indices()
    return B


def _brusselator(N):
    pat = jbru.sparsity_pattern(N)
    n = pat.shape[0]
    return sp.csr_matrix((np.ones(len(pat.indices)), np.asarray(pat.indices),
                          np.asarray(pat.indptr)), shape=(n, n))


def _scrambled_tridiag(n):
    i = np.arange(n - 1)
    rows = np.concatenate([i, np.arange(n), i + 1])
    cols = np.concatenate([i + 1, np.arange(n), i])
    s = np.random.default_rng(42).permutation(n)
    return sp.coo_matrix((np.ones(len(rows)), (s[rows], s[cols])),
                         shape=(n, n)).tocsr()


def _random_wide():
    r = np.random.default_rng(7)
    rows = np.repeat(np.arange(2048), 16)
    cols = r.integers(0, 131072, size=rows.size)
    A = sp.coo_matrix((r.standard_normal(rows.size), (rows, cols)),
                      shape=(2048, 131072)).tocsr()
    A.sum_duplicates()
    return A


def _same_ell(j, t):
    assert (t.w, t.W, t.mode, t.n_pad, t.supported) == \
        (j.w, j.W, j.mode, j.n_pad, j.supported)


def assert_same_plan(jout, tout):
    """The two packages' ``select_spmv_plan`` answers agree: tier, reorder,
    and the plan's acceptance and cost fields."""
    jt, jplan, jperm = jout[:3]
    tt, tplan, tperm = tout[:3]
    assert tt == jt
    assert (tperm is None) == (jperm is None)
    if jperm is not None:
        for a, b in zip(jout[2:], tout[2:]):
            np.testing.assert_array_equal(b, a)
    if jt == "dia":
        assert tplan.offsets == jplan.offsets
    elif jt == "resident":
        _same_ell(jplan, tplan)
    elif jt == "stream":
        assert (tplan.w, tplan.bands, tplan.F, tplan.group_lo_t,
                tplan.n_pad) == (jplan.w, jplan.bands, jplan.F,
                                 jplan.group_lo_t, jplan.n_pad)
    elif jt == "scatter":
        assert tplan.cost == jplan.cost
        assert tplan.table_bytes == jplan.table_bytes
        assert len(tplan.parts) == len(jplan.parts)
        for (jc0, jc1, jsel, jp), (tc0, tc1, tsel, tp) in zip(jplan.parts,
                                                               tplan.parts):
            assert (tc0, tc1, tp.B, tp.P) == (jc0, jc1, jp.B, jp.P)
            np.testing.assert_array_equal(tsel, jsel)
            np.testing.assert_array_equal(tp.sigma, jp.sigma)
            _same_ell(jp.g_plan, tp.g_plan)
            assert len(tp.r_plans) == len(jp.r_plans)
            for a, b in zip(jp.r_plans, tp.r_plans):
                _same_ell(a, b)
    tcost = tps.spmv_tier_cost(tt, tplan) if tt else None
    jcost = jps.spmv_tier_cost(jt, jplan) if jt else None
    assert tcost == jcost


# case: (pattern, caps on both sides, expected tier, reordered?)
TIER_CASES = {
    "tridiagonal-2000": (lambda: _tridiag(2000), {}, "dia", False),
    "tridiagonal-5000-no-dia": (
        lambda: _tridiag(5000),
        {"MAX_X_ELEMS_VMEM": 1000, "DIA_MAX_OFFSETS": 0}, "stream", False),
    "scrambled-tridiagonal-65536": (
        lambda: _scrambled_tridiag(65536), {"MAX_X_ELEMS_VMEM": 1000},
        "stream", True),
    "brusselator-256-permuted": (
        lambda: _permuted(_brusselator(256), 0), {}, "resident", True),
    "brusselator-128-permuted": (
        lambda: _permuted(_brusselator(128), 0), {}, "scatter", False),
    "random-2048x131072-w16": (_random_wide, {}, "scatter", False),
    "periodic7-40": (
        lambda: sp.csr_matrix((np.ones(7 * 40 ** 3), periodic7(40)[1],
                               periodic7(40)[0]), shape=(40 ** 3,) * 2),
        {"DIA_MAX_TABLE": 500_000, "MAX_X_ELEMS_VMEM": 32_768}, "stream",
        False),
}


@pytest.mark.parametrize("case", sorted(TIER_CASES))
def test_tier_selection_equals_jax(case, caps):
    build, cap_values, tier, reordered = TIER_CASES[case]
    A = build()
    caps(**cap_values)
    n, m = A.shape
    jout = jps.select_spmv_plan(A.indptr, A.indices, n, m)
    tout = tps.select_spmv_plan(A.indptr.astype(np.int32),
                                A.indices.astype(np.int32), n, m)
    assert_same_plan(jout, tout)
    assert tout[0] == tier and (tout[2] is not None) == reordered
    if case == "periodic7-40":
        plan = tout[1]
        assert (plan.w, len(plan.bands), plan.F) == (11, 5, 124)
        per_nnz = (tps._derated_cost("stream", plan) * (plan.n_pad / 128)
                   / A.nnz)
        assert per_nnz == pytest.approx(0.3465, abs=5e-5)
        assert per_nnz < tps._SCATTER_TRY_THRESHOLD


def test_transpose_pattern_equals_jax():
    A = _permuted(_brusselator(16), 3)
    got = tps.transpose_pattern_of(A.indptr, A.indices, *A.shape)
    ref = jps.transpose_pattern_of(A.indptr, A.indices, *A.shape)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_rcm_ordering_equals_jax():
    from nonlinearsolve_tpu import native as jnative
    from nonlinearsolve_tpu_torch import native as tnative
    A = _permuted(_brusselator(16), 1)
    n = A.shape[0]
    np.testing.assert_array_equal(
        tnative.rcm_ordering(A.indptr, A.indices, n),
        jnative.rcm_ordering(A.indptr, A.indices, n))


# ---------------------------------------------------------------------------
# K7 (plain) against the Pallas band kernel in interpret mode
# ---------------------------------------------------------------------------

def _rand_data(A, seed):
    A = A.tocsr()
    A.sum_duplicates()
    A.data = np.random.default_rng(seed).standard_normal(A.nnz)
    return A


def _check_k7(indptr, indices, data, shape, seed=0):
    """The port's band product against the JAX package's (interpret mode)
    and against A·x; the port's tables describe the CSR.  Returns the
    port's plan."""
    n, m = shape
    jplan = jst.BandPlan(np.asarray(indptr, np.int64),
                         np.asarray(indices, np.int64), n, m)
    tplan = tst.BandPlan(indptr, indices, n, m)
    assert tplan.ok and jplan.ok
    assert (tplan.w, tplan.bands, tplan.F, tplan.group_lo_t) == \
        (jplan.w, jplan.bands, jplan.F, jplan.group_lo_t)
    # every non-pad slot holds a CSR entry of its row, and each entry once
    valid = tplan.cols >= 0
    pos = tplan.pos.reshape(tplan.w, tplan.n_pad)
    rows = np.broadcast_to(np.arange(tplan.n_pad), valid.shape)[valid]
    row_of = np.repeat(np.arange(n), np.diff(indptr))
    np.testing.assert_array_equal(np.sort(pos[valid]), np.arange(len(data)))
    np.testing.assert_array_equal(row_of[pos[valid]], rows)
    np.testing.assert_array_equal(np.asarray(indices)[pos[valid]],
                                  tplan.cols[valid])
    assert (pos[~valid] == len(data)).all()
    x = np.random.default_rng(seed).standard_normal(m)
    ref = np.asarray(jst.band_spmv_pallas(jplan, jnp.asarray(data),
                                          jnp.asarray(x), interpret=True))
    got = tst.band_spmv(tplan, torch.tensor(data), torch.tensor(x)).numpy()
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= 1e-13 * scale
    dense = sp.csr_matrix((data, indices, indptr), shape=shape) @ x
    assert np.abs(got - dense).max() <= 1e-13 * scale
    return tplan


def _k7_case(case):
    if case == "tridiagonal":
        return _rand_data(_tridiag(3000), 1)
    if case == "3d-7point-boundary":
        n1 = 16
        n = n1 ** 3
        offs = [0, 1, -1, n1, -n1, n1 * n1, -n1 * n1]
        return _rand_data(sp.diags([np.ones(n)] + [np.ones(n - abs(o))
                                                   for o in offs[1:]], offs),
                          2)
    if case == "periodic-brusselator-wraps":
        return _rand_data(_brusselator(32), 3)
    if case == "rectangular":
        i = np.arange(1000)
        return _rand_data(sp.coo_matrix(
            (np.ones(2000), (np.concatenate([i, i]),
                             np.concatenate([i * 2, i * 3]))),
            shape=(1000, 3500)), 4)
    if case == "multi-nnz-bands":
        i = np.repeat(np.arange(1500), 4)
        c = np.clip(i + np.tile([0, 3, 7, 11], 1500), 0, 1499)
        return _rand_data(sp.coo_matrix((np.ones(6000), (i, c)),
                                        shape=(1500, 1500)), 5)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["tridiagonal", "3d-7point-boundary",
                                  "periodic-brusselator-wraps", "rectangular",
                                  "multi-nnz-bands"])
def test_plain_k7_equals_band_spmv_pallas(case):
    A = _k7_case(case)
    plan = _check_k7(A.indptr, A.indices, A.data, A.shape)
    if case == "tridiagonal":
        assert plan.w == 3 and len(plan.bands) == 1
    if case == "3d-7point-boundary":
        assert plan.w == 7
    if case == "periodic-brusselator-wraps":
        assert len(plan.group_lo_t) > 1 or plan.F <= 64


def test_plain_k7_unsorted_columns_equals_band_spmv_pallas():
    """Unsorted per-row columns: the plan sorts them (the slot order is the
    sorted one), and ``pos`` points at the original CSR positions."""
    n = 4096
    m = n - 2048
    cols = np.empty(3 * m, np.int64)
    cols[0::3] = np.arange(m)
    cols[1::3] = np.arange(m) + 2048
    cols[2::3] = np.arange(m) + 1
    data = np.random.default_rng(6).standard_normal(3 * m)
    indptr = np.arange(m + 1) * 3
    assert not tst._rows_sorted(indptr, cols)
    _check_k7(indptr, cols, data, (m, n))


def test_band_staged_equals_unstaged_and_counts_no_launch():
    A = _k7_case("3d-7point-boundary")
    plan = tst.BandPlan(A.indptr, A.indices, *A.shape)
    data = torch.tensor(A.data)
    x = torch.tensor(np.random.default_rng(7).standard_normal(A.shape[1]))
    before = dict(_backend.LAUNCHES)
    mv = tst.band_spmv_staged(plan, data)
    assert torch.equal(mv(x), tst.band_spmv(plan, data, x))
    assert _backend.LAUNCHES == before          # plain versions on the CPU


def test_band_pad_slots_are_not_read():
    """inf in every pad slot of the packed data changes nothing."""
    A = _k7_case("multi-nnz-bands")
    plan = tst.BandPlan(A.indptr, A.indices, *A.shape)
    packed = plan.pack_data(torch.tensor(A.data))
    cols = torch.as_tensor(plan.cols)
    x = torch.tensor(np.random.default_rng(8).standard_normal(A.shape[1]))
    y = tst.band_spmv_packed(cols, packed, x, A.shape[0])
    packed_inf = packed.clone()
    packed_inf[cols < 0] = float("inf")
    y_inf = tst.band_spmv_packed(cols, packed_inf, x, A.shape[0])
    assert bool(torch.isfinite(y_inf).all())
    assert torch.equal(y_inf, y)


def test_band_plan_refuses_random_patterns():
    rng = np.random.default_rng(42)
    n = 65536
    cols = np.sort(rng.integers(0, n, size=(2048, 8)), axis=1)
    indptr = np.arange(2049) * 8
    assert not tst.BandPlan(indptr, cols.reshape(-1), 2048, n).ok
    assert not jst.BandPlan(indptr, cols.reshape(-1), 2048, n).ok


def _random_300():
    r = np.random.default_rng(1)
    rows = np.repeat(np.arange(300), 6)
    A = sp.coo_matrix((np.ones(rows.size), (rows, r.integers(0, 300,
                                                             rows.size))),
                      shape=(300, 300)).tocsr()
    A.sum_duplicates()
    return A


# case: (pattern, caps on both sides, expected tier, reordered?)
ROUTE_CASES = {
    "dia": (lambda: _tridiag(2000), {}, "dia", False),
    "resident": (_random_300, {}, "resident", False),
    "stream": (lambda: _tridiag(5000),
               {"MAX_X_ELEMS_VMEM": 1000, "DIA_MAX_OFFSETS": 0}, "stream",
               False),
    "stream-rcm": (lambda: _scrambled_tridiag(65536),
                   {"MAX_X_ELEMS_VMEM": 1000}, "stream", True),
    "scatter": (_random_wide, {}, "scatter", False),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_csr_matvec_routes_every_tier(case, caps):
    """``CSR.matvec`` and ``matvec_fn`` give A·x on every tier (the plain
    K4, K5, K7 with and without the RCM gathers, K8)."""
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    build, cap_values, tier, reordered = ROUTE_CASES[case]
    caps(**cap_values)
    A = _rand_data(build(), 9)
    T = CSR(torch.tensor(A.data), A.indices, A.indptr, A.shape)
    assert T.tier[0] == tier and (T.tier[2] is not None) == reordered
    x = np.random.default_rng(10).standard_normal(A.shape[1])
    ref = A @ x
    scale = max(np.abs(ref).max(), 1.0)
    for got in (T.matvec(torch.tensor(x)), T.matvec_fn()(torch.tensor(x))):
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * scale

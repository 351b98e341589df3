"""The port's expand/regroup tier (kernel K8's plain versions,
``ops/spmv_scatter.py``) against the JAX package, on the CPU (f64).

``scatter_spmv`` (the plain expand and regroup on the CPU) against
``scatter_spmv_pallas`` (interpret mode off the TPU) on the JAX scatter
tests' patterns: random square and rectangular, dense rows with a chained
R, column parts with the x cap lowered on both sides, empty rows and
columns.  Rel-inf 1e-12 (the same products, regrouped in another order).
The plans agree field by field: parts, zone heights, σ, the G and R plans,
their costs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from nonlinearsolve_tpu.ops import pallas_spmv as jps
from nonlinearsolve_tpu.ops import pallas_spmv_scatter as jsc
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.ops import spmv as tps
from nonlinearsolve_tpu_torch.ops import spmv_scatter as tsc

torch.set_num_threads(2)


def _rand_csr(n_rows, n_cols, w, seed=0, dense_rows=0, dense_w=100):
    r = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), w)
    cols = r.integers(0, n_cols, size=rows.size)
    if dense_rows:
        rows = np.concatenate(
            [rows, np.repeat(np.arange(dense_rows), dense_w)])
        cols = np.concatenate(
            [cols, r.integers(0, n_cols, size=dense_rows * dense_w)])
    A = sp.coo_matrix((r.standard_normal(rows.size), (rows, cols)),
                      shape=(n_rows, n_cols)).tocsr()
    A.sum_duplicates()
    return A


def _empty_rows_and_columns():
    r = np.random.default_rng(8)
    rows = r.integers(100, 400, size=900)
    cols = r.integers(50, 300, size=900)
    A = sp.coo_matrix((r.standard_normal(900), (rows, cols)),
                      shape=(512, 512)).tocsr()
    A.sum_duplicates()
    return A


CASES = {
    "random-square": lambda: _rand_csr(500, 500, 5, seed=2),
    "random-rectangular": lambda: _rand_csr(300, 700, 4, seed=3),
    "dense-rows-chained-r": lambda: _rand_csr(400, 400, 3, seed=4,
                                              dense_rows=5),
    "column-parts": lambda: _rand_csr(512, 4096, 3, seed=5),
    "empty-rows-and-columns": _empty_rows_and_columns,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k8_equals_scatter_spmv_pallas(case, monkeypatch):
    if case == "column-parts":
        for mod in (jps, tps):
            monkeypatch.setattr(mod, "MAX_X_ELEMS_VMEM", 2048)
    A = CASES[case]()
    jplan = jsc.ScatterPlan(A.indptr, A.indices, *A.shape)
    tplan = tsc.ScatterPlan(A.indptr, A.indices, *A.shape)
    assert jplan.supported and tplan.supported
    assert (tplan.cost, tplan.table_bytes) == (jplan.cost, jplan.table_bytes)
    assert [p[:2] for p in tplan.parts] == [p[:2] for p in jplan.parts]
    for (_a, _b, jsel, jp), (_c, _d, tsel, tp) in zip(jplan.parts,
                                                      tplan.parts):
        assert (tp.B, tp.P, len(tp.r_plans)) == (jp.B, jp.P, len(jp.r_plans))
        np.testing.assert_array_equal(tsel, jsel)
        np.testing.assert_array_equal(tp.sigma, jp.sigma)
    if case == "dense-rows-chained-r":
        assert any(len(p.r_plans) >= 2 for (*_, p) in tplan.parts)
    if case == "column-parts":
        assert len(tplan.parts) >= 2
    x = np.random.default_rng(1).standard_normal(A.shape[1])
    ref = np.asarray(jsc.scatter_spmv_pallas(jplan, jnp.asarray(A.data),
                                             jnp.asarray(x)))
    got = tsc.scatter_spmv(tplan, torch.tensor(A.data),
                           torch.tensor(x)).numpy()
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(got - ref).max() <= 1e-12 * scale
    assert np.abs(got - A @ x).max() <= 1e-12 * scale


def test_scatter_tables_describe_the_plan():
    """``gcol`` holds each G position's column (−1 in zone pads), the
    staging selection its CSR position, and the R tables sum each row's
    positions: together they rebuild A."""
    A = CASES["dense-rows-chained-r"]()
    plan = tsc.ScatterPlan(A.indptr, A.indices, *A.shape)
    (c0, c1, sel, part), = plan.parts
    gsrc = plan.sel.src
    pads = part.gcol < 0
    assert (gsrc[pads] == A.nnz).all()
    np.testing.assert_array_equal(part.gcol[~pads], A.indices[gsrc[~pads]])
    # the R chain maps every G position to its CSR row
    owner = np.arange(part.P)
    for indptr, pos in part.r_tables:
        row_of_k = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        new_owner = np.full(part.P, -1)
        where = np.full(owner.max() + 1, -1)
        where[pos] = row_of_k
        new_owner[owner >= 0] = where[owner[owner >= 0]]
        owner = new_owner
    row_of = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    np.testing.assert_array_equal(owner[~pads], row_of[gsrc[~pads]])


def test_scatter_staged_equals_unstaged_and_counts_no_launch():
    A = CASES["random-square"]()
    plan = tsc.ScatterPlan(A.indptr, A.indices, *A.shape)
    data = torch.tensor(A.data)
    x = torch.tensor(np.random.default_rng(2).standard_normal(A.shape[1]))
    before = dict(_backend.LAUNCHES)
    mv = tsc.scatter_spmv_staged(plan, data)
    assert torch.equal(mv(x), tsc.scatter_spmv(plan, data, x))
    assert _backend.LAUNCHES == before          # plain versions on the CPU


def test_plain_expand_and_regroup():
    gcol = torch.tensor([2, -1, 0, 1], dtype=torch.int32)
    gdata = torch.tensor([1.5, float("inf"), -2.0, 4.0], dtype=torch.float64)
    x = torch.tensor([3.0, 0.5, 2.0], dtype=torch.float64)
    p = tsc.scatter_expand_plain(gcol, gdata, x)
    assert p.tolist() == [3.0, 0.0, -6.0, 2.0]
    indptr = torch.tensor([0, 2, 2, 4], dtype=torch.int32)
    pos = torch.tensor([0, 3, 1, 2], dtype=torch.int32)
    assert tsc.scatter_regroup_plain(indptr, pos, p).tolist() == \
        [5.0, 0.0, -6.0]

"""K8 fused (``ops/spmv_scatter.py`` ``scatter_spmv_part``) on the CPU:
its tables, its sequential reference, and a model of the kernel's sum.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here the CPU holds what it reads and the order in which it sums:

- the per-part tables (``PartTables``: zone starts, the part's CSR
  indptr, the positions) describe the JAX plan: every row's positions
  lie inside its zone, and the zones tile the G positions;
- ``scatter_part_sequential`` (each R level summed one slot at a time,
  the reference the card is held to) equals the two-pass plain versions
  (``scatter_expand_plain``, then ``scatter_regroup_plain``, which sums in
  order on the CPU) bit for bit, in f32 and f64, with zone pads, empty
  rows, R chains of depth 1, 2 and 3, and 1 to 3 column parts;
- ``_kernel_sum``, a line-for-line model of ``chain_sum`` in
  ``csrc/spmv.cu`` (each row at its own chain depth), gives the same
  bits, so the kernel's association is the plan's.

Every comparison here is exact (``torch.equal``): the same products, the
same additions in the same order.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from nonlinearsolve_tpu_torch.ops import spmv as tps
from nonlinearsolve_tpu_torch.ops import spmv_scatter as tsc

torch.set_num_threads(2)

K_SLOTS = 32        # csrc/spmv.cu kSlots, the plan's MAX_SLOTS


def _csr(n_rows, n_cols, w, seed, dense=(), empty=()):
    """``w`` random columns a row, plus ``dense`` rows of (row, width)
    distinct columns; the ``empty`` rows hold nothing."""
    r = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n_rows), w)
    cols = r.integers(0, n_cols, size=rows.size)
    for row, width in dense:
        rows = np.concatenate([rows, np.full(width, row)])
        cols = np.concatenate([cols, r.choice(n_cols, width, replace=False)])
    keep = ~np.isin(rows, np.asarray(empty, np.int64))
    rows, cols = rows[keep], cols[keep]
    A = sp.coo_matrix((r.standard_normal(rows.size), (rows, cols)),
                      shape=(n_rows, n_cols)).tocsr()
    A.sum_duplicates()
    return A


# name: (matrix, MAX_X_ELEMS_VMEM or None, parts, deepest R chain)
CASES = {
    "depth1-one-part": (lambda: _csr(600, 3000, 7, 1), None, 1, 1),
    "depth2-one-part": (lambda: _csr(600, 3000, 7, 2, dense=((5, 100),)),
                        None, 1, 2),
    "depth3-one-part": (lambda: _csr(600, 3000, 7, 3,
                                     dense=((5, 100), (300, 1100))),
                        None, 1, 3),
    "empty-rows-two-parts": (lambda: _csr(700, 3000, 3, 4,
                                          empty=range(200, 420)),
                             2048, 2, 1),
    "depth2-three-parts": (lambda: _csr(600, 4096, 4, 5, dense=((9, 300),)),
                           2048, 3, 2),
    "depth3-three-parts": (lambda: _csr(500, 9000, 3, 6,
                                        dense=((7, 3400), (400, 40))),
                           4096, 3, 3),
}


@pytest.fixture
def case(request, monkeypatch):
    make, cap, parts, depth = CASES[request.param]
    if cap is not None:
        monkeypatch.setattr(tps, "MAX_X_ELEMS_VMEM", cap)
    A = make()
    plan = tsc.ScatterPlan(A.indptr, A.indices, *A.shape)
    assert plan.ok and len(plan.parts) == parts
    assert max(len(p.r_plans) for (*_, p) in plan.parts) == depth
    return A, plan


def _inputs(A, dtype, seed):
    r = np.random.default_rng(seed)
    data = torch.tensor(r.standard_normal(A.nnz), dtype=dtype)
    x = torch.tensor(r.standard_normal(A.shape[1]), dtype=dtype)
    return data, x


@pytest.mark.parametrize("case", sorted(CASES), indirect=True)
def test_part_tables_describe_the_plan(case):
    A, plan = case
    row_of = np.repeat(np.arange(A.shape[0]), np.diff(A.indptr))
    for t, (c0, c1, sel, part) in zip(plan.tables("cpu"), plan.parts):
        assert (t.c0, t.c1, t.rows_per_zone) == (c0, c1, part.B)
        zstart = t.zstart.numpy().astype(np.int64)
        n_zones = -(-A.shape[0] // part.B)
        assert zstart.shape == (n_zones + 1,)
        assert zstart[0] == 0 and zstart[-1] == part.P
        assert (np.diff(zstart) >= 0).all()
        assert t.max_zone == np.diff(zstart).max()
        # each zone padded to whole 128-position tiles, pads marked -1
        assert (zstart % 128 == 0).all()
        gcol = t.gcol.numpy()
        live = np.zeros(part.P, bool)
        live[part.pos_sorted] = True
        assert (gcol[~live] == -1).all() and (gcol[live] >= 0).all()
        # rptr is the part's CSR indptr over A's rows
        counts = np.bincount(row_of[sel], minlength=A.shape[0])
        np.testing.assert_array_equal(
            t.rptr.numpy(), np.concatenate([[0], np.cumsum(counts)]))
        # pos: every nonzero's G position, inside its row's zone, and its
        # column there
        pos = t.pos.numpy().astype(np.int64)
        assert np.array_equal(np.sort(pos), np.sort(part.pos_sorted))
        prow = np.repeat(np.arange(A.shape[0]), counts)
        zone = prow // part.B
        assert ((pos >= zstart[zone]) & (pos < zstart[zone + 1])).all()
        np.testing.assert_array_equal(gcol[pos], A.indices[sel] - c0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", sorted(CASES), indirect=True)
def test_sequential_reference_equals_two_pass_plain(case, dtype):
    A, plan = case
    data, x = _inputs(A, dtype, 7)
    staged = plan.stage(data)
    y_two = y_seq = y_k8 = None
    for t, gdata in zip(plan.tables("cpu"), staged):
        y_two = tsc.scatter_part_plain(t, gdata, x, y_two)
        y_seq = tsc.scatter_part_sequential(t, gdata, x, y_seq)
        # the wrapper adds a later part into the y it is given, in place
        y_in = y_k8
        y_k8 = tsc.scatter_spmv_part(t, gdata, x, y_k8)
        assert y_in is None or y_k8 is y_in
    assert torch.equal(y_seq, y_two)
    assert torch.equal(y_k8, y_two)
    assert torch.equal(tsc.scatter_spmv(plan, data, x), y_two)
    ref = sp.csr_matrix((data.double().numpy(), A.indices, A.indptr),
                        shape=A.shape) @ x.double().numpy()
    scale = max(np.abs(ref).max(), 1.0)
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    assert np.abs(y_two.double().numpy() - ref).max() <= tol * scale


def _kernel_sum(terms, zero):
    """``chain_sum`` of csrc/spmv.cu, line for line, on numpy scalars."""
    c = len(terms)
    if c <= K_SLOTS:
        acc = zero
        for v in terms:
            acc = acc + v
        return acc
    depth, cap = 2, K_SLOTS * K_SLOTS
    while c > cap:
        cap *= K_SLOTS
        depth += 1
    acc, cnt = [zero] * depth, [0] * depth
    for v in terms:
        acc[0] = acc[0] + v
        lv = 0
        while True:
            cnt[lv] += 1
            if not (cnt[lv] == K_SLOTS and lv + 1 < depth):
                break
            acc[lv + 1] = acc[lv + 1] + acc[lv]
            acc[lv], cnt[lv] = zero, 0
            lv += 1
    for lv in range(depth - 1):
        if cnt[lv] > 0:
            acc[lv + 1] = acc[lv + 1] + acc[lv]
            cnt[lv + 1] += 1
    return acc[depth - 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["depth3-one-part", "depth3-three-parts",
                                  "empty-rows-two-parts"], indirect=True)
def test_kernel_sum_model_equals_sequential_reference(case, dtype):
    A, plan = case
    data, x = _inputs(A, dtype, 9)
    zero = np.dtype(str(dtype).split(".")[-1]).type(0)
    y_ref = y_model = None
    for t, gdata in zip(plan.tables("cpu"), plan.stage(data)):
        y_ref = tsc.scatter_part_sequential(t, gdata, x, y_ref)
        prod = tsc.scatter_expand_plain(t.gcol, gdata,
                                        x[t.c0:t.c1]).numpy()
        rptr, pos = t.rptr.numpy(), t.pos.numpy()
        part = np.array([_kernel_sum(list(prod[pos[rptr[r]:rptr[r + 1]]]),
                                     zero)
                         for r in range(A.shape[0])], dtype=zero.dtype)
        y_model = part if y_model is None else y_model + part
    assert torch.equal(torch.from_numpy(y_model), y_ref)


def test_slot_sum_keeps_order_and_signs():
    """Rows in R's order, an empty row, a row of -0.0 (sums begun at +0
    end at +0, as the kernel's do) and inf."""
    p = torch.tensor([1e16, 1.0, -1e16, -0.0, float("inf"), 2.0],
                     dtype=torch.float64)
    indptr = torch.tensor([0, 3, 3, 4, 6], dtype=torch.int32)
    pos = torch.tensor([0, 1, 2, 3, 4, 5], dtype=torch.int32)
    got = tsc.slot_sum_plain(indptr, pos, p, 3)
    ref = tsc.scatter_regroup_plain(indptr, pos, p)
    assert torch.equal(got, ref)
    assert got.tolist() == [0.0, 0.0, 0.0, float("inf")]
    assert not torch.signbit(got[2])

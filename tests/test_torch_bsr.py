"""The port's block-sparse layer against the JAX package, on the same seeded
numpy inputs (f64 unless stated): ``CSR.from_dense`` / ``rmatvec`` /
``to_ell``, ``ELL``, ``DIA.from_csr``, ``BSR``, ``spmv``, the BSR entry
points of ``ops/spmv.py`` (``bsr_scalar_pattern``, ``bsr_spmv`` on the plain
K5, ``bsr_spmm_plain`` and the K6 wrapper's CPU route) and the Jacobi and
block-Jacobi preconditioners.

Tolerances: patterns, tables, layouts, dense copies, diagonals and blocks
exactly; products at rtol 1e-12 of max|y| in f64 and 1e-5 in f32 (the same
products, summed in another order); K6 times the colour seeds bit for bit
against the compressed colored JVPs (one nonzero product an output, the
rest exact zeros).  The JAX K6 runs in interpret mode on 64 block rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinearsolve_tpu import native as jnative
from nonlinearsolve_tpu.ops import pallas_spmv as jps
from nonlinearsolve_tpu.ops import preconditioners as jpre
from nonlinearsolve_tpu.ops import sparse as jsp
from nonlinearsolve_tpu_torch import interop, native
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.ops import preconditioners as tpre
from nonlinearsolve_tpu_torch.ops import sparse as tsp
from nonlinearsolve_tpu_torch.ops import spmv as tspmv
from nonlinearsolve_tpu_torch.ops.operators import as_matvec, mv
from nonlinearsolve_tpu_torch.ops.sparse_jac import plan_sparse_jacobian

torch.set_num_threads(2)

RTOL = {"float64": 1e-12, "float32": 1e-5}
NP_DT = {"float64": np.float64, "float32": np.float32}


def _close(got, ref, rtol=1e-12):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(initial=0.0), 1.0)
    assert np.abs(got - ref).max(initial=0.0) <= rtol * scale


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# scalar containers: CSR.from_dense / rmatvec / to_ell, ELL, DIA.from_csr
# ---------------------------------------------------------------------------

def _scalar_case(case):
    if case == "krylov":        # tests/test_sparse_krylov.py:63-80
        rng = np.random.default_rng(0)
        A = rng.standard_normal((12, 12))
        A[rng.random((12, 12)) < 0.7] = 0.0
    elif case == "native":      # tests/test_native.py:55-66
        rng = np.random.default_rng(5)
        A = np.where(rng.random((30, 30)) < 0.2,
                     rng.standard_normal((30, 30)), 0.0)
    elif case == "banded":      # tests/test_sparse_krylov.py:82-94
        n = 16
        A = (np.diag(2.0 * np.ones(n)) + np.diag(-np.ones(n - 1), 1)
             + np.diag(-np.ones(n - 1), -1) + np.diag(0.5 * np.ones(n - 3), 3))
        rng = np.random.default_rng(1)
    else:                       # rectangular, with an empty row
        rng = np.random.default_rng(11)
        A = np.where(rng.random((20, 13)) < 0.3,
                     rng.standard_normal((20, 13)), 0.0)
        A[4] = 0.0
    return A, rng


@pytest.mark.parametrize("case", ["krylov", "native", "banded", "rect"])
def test_scalar_containers_equal_jax(case):
    A, rng = _scalar_case(case)
    x = rng.standard_normal(A.shape[1])
    y = rng.standard_normal(A.shape[0])
    J = jsp.CSR.from_dense(A)
    T = tsp.CSR.from_dense(A, device="cpu")
    np.testing.assert_array_equal(T.indptr, J.indptr)
    np.testing.assert_array_equal(T.indices, J.indices)
    np.testing.assert_array_equal(_np(T.data), np.asarray(J.data))
    assert T.shape == J.shape
    _close(_np(T.matvec(torch.tensor(x))), J.matvec(jnp.asarray(x)))
    jr = np.asarray(J.rmatvec(jnp.asarray(y)))
    _close(_np(T.rmatvec(torch.tensor(y))), jr)
    _close(_np(T.rmatvec_fn()(torch.tensor(y))), jr)
    _close(jr, A.T @ y)
    np.testing.assert_array_equal(_np(T.todense()), np.asarray(J.todense()))

    # ELL: the native plan, the layout and its products
    plan_t = native.ell_plan(T.indptr, T.indices, A.shape[0])
    plan_j = jnative.ell_plan(J.indptr, J.indices, A.shape[0])
    if plan_j is not None:
        assert plan_t[0] == plan_j[0]
        for a, b in zip(plan_t[1:], plan_j[1:]):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype
    je, te = J.to_ell(), T.to_ell()
    assert te.width == je.width and te.shape == je.shape
    np.testing.assert_array_equal(te.cols, je.cols)
    np.testing.assert_array_equal(te.valid, je.valid)
    np.testing.assert_array_equal(_np(te.data), np.asarray(je.data))
    ref = np.asarray(je.matvec(jnp.asarray(x)))
    for got in (te.matvec(torch.tensor(x)), mv(te, torch.tensor(x)),
                as_matvec(te)(torch.tensor(x)),
                tsp.spmv(te, torch.tensor(x))):
        _close(_np(got), ref)
    np.testing.assert_array_equal(_np(te.todense()), np.asarray(je.todense()))
    np.testing.assert_array_equal(_np(te.todense()), A)
    te2 = interop.ell_from_numpy(np.asarray(je.data), je.cols, je.valid,
                                 je.shape, device="cpu")
    _close(_np(te2.matvec(torch.tensor(x))), ref)

    # DIA, on the banded case as the JAX test has it (the JAX DIA.from_csr
    # compiles one update a diagonal: seconds on the scattered patterns)
    if case == "banded":
        jd, td = jsp.DIA.from_csr(J), tsp.DIA.from_csr(T)
        assert td.offsets == tuple(int(o) for o in jd.offsets)
        np.testing.assert_array_equal(_np(td.data), np.asarray(jd.data))
        _close(_np(td.matvec(torch.tensor(x))), jd.matvec(jnp.asarray(x)))
        np.testing.assert_array_equal(_np(td.todense()), A)


def test_ell_pads_add_nothing():
    """A pad slot points at column 0 with data 0: the port's masked row
    sum keeps an inf there out of the rows that do not read column 0."""
    A = np.array([[0.0, 1.0, 2.0], [3.0, 0.0, 0.0], [0.0, 0.0, 4.0]])
    te = tsp.CSR.from_dense(A, device="cpu").to_ell()
    x = torch.tensor([np.inf, 1.0, 1.0])
    y = te.matvec(x)
    assert bool(torch.isinf(y[1])) and y[0] == 3.0 and y[2] == 4.0


def test_ell_plan_refuses_a_malformed_pattern():
    with pytest.raises(ValueError):
        native.ell_plan(np.array([0, 2]), np.array([0], np.int32), 1)


# ---------------------------------------------------------------------------
# BSR containers
# ---------------------------------------------------------------------------

def _block_dense(rng, nbr, nbc, b, empty_row):
    """A block-sparse matrix (TestBSR's recipe, tests/test_sparse_krylov.py
    :491-500) with explicit zeros inside its blocks and one empty block
    row."""
    A = np.zeros((nbr * b, nbc * b))
    for i in range(nbr):
        if i == empty_row:
            continue
        for j in range(nbc):
            if i == j or rng.random() < 0.3:
                A[i * b:(i + 1) * b, j * b:(j + 1) * b] = \
                    rng.standard_normal((b, b))
    A[rng.random(A.shape) < 0.2] = 0.0
    return A


@pytest.mark.parametrize("b", [2, 3, 4])
@pytest.mark.parametrize("shape", [(7, 7), (5, 8), (8, 5)])
def test_bsr_equals_jax(b, shape):
    rng = np.random.default_rng(10 * b + shape[1])
    A = _block_dense(rng, *shape, b, empty_row=2)
    J = jsp.BSR.from_csr(jsp.CSR.from_dense(A), b)
    T = tsp.BSR.from_csr(tsp.CSR.from_dense(A, device="cpu"), b)
    np.testing.assert_array_equal(T.indptr, J.indptr)
    np.testing.assert_array_equal(T.indices, J.indices)
    np.testing.assert_array_equal(T.block_row_ids, J.block_row_ids)
    np.testing.assert_array_equal(_np(T.data), np.asarray(J.data))
    assert T.nnz == J.nnz and T.shape == J.shape
    np.testing.assert_array_equal(_np(T.todense()), np.asarray(J.todense()))
    np.testing.assert_array_equal(_np(T.todense()), A)
    x = rng.standard_normal(A.shape[1])
    y = rng.standard_normal(A.shape[0])
    ref = np.asarray(J.matvec(jnp.asarray(x)))
    _close(ref, A @ x)
    for got in (T.matvec(torch.tensor(x)), tsp.spmv(T, torch.tensor(x)),
                tspmv.bsr_spmv(T, torch.tensor(x))):
        _close(_np(got), ref)
    _close(_np(T.rmatvec(torch.tensor(y))), J.rmatvec(jnp.asarray(y)))
    # the diagonal blocks: those whose column is their row — block row 2
    # has none, so both packages give fewer than n / b of them
    np.testing.assert_array_equal(_np(T.diag_blocks()),
                                  np.asarray(J.diag_blocks()))
    np.testing.assert_array_equal(_np(T.diagonal()), np.asarray(J.diagonal()))
    assert T.diag_blocks().shape[0] == min(shape) - 1
    T2 = interop.bsr_from_numpy(np.asarray(J.data), J.indices, J.indptr,
                                J.shape, b, device="cpu")
    _close(_np(T2.matvec(torch.tensor(x))), ref)
    T3 = T.with_data(2.0 * T.data)
    assert T3._shared is T._shared
    _close(_np(T3.matvec(torch.tensor(x))), 2.0 * ref)


def test_block_jacobi_on_a_missing_diagonal_block_raises_in_both():
    rng = np.random.default_rng(4)
    A = _block_dense(rng, 5, 5, 2, empty_row=1) + 5.0 * np.eye(10)
    A[2:4, 2:4] = 0.0               # block row 1: no diagonal block
    J = jsp.BSR.from_csr(jsp.CSR.from_dense(A), 2)
    T = tsp.BSR.from_csr(tsp.CSR.from_dense(A, device="cpu"), 2)
    assert T.diag_blocks().shape == J.diag_blocks().shape == (4, 2, 2)
    v = rng.standard_normal(10)
    with pytest.raises(TypeError):
        jpre.block_jacobi_preconditioner(J.diag_blocks())(jnp.asarray(v))
    with pytest.raises(RuntimeError):
        tpre.block_jacobi_preconditioner(T.diag_blocks())(torch.tensor(v))


def _irregular_pair(rng, nbr, nbc, b):
    """The same BSR in both packages from raw arrays: block columns
    unsorted within a row, repeated columns and empty rows."""
    counts = rng.integers(0, 5, size=nbr)
    counts[1] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)])
    indices = rng.integers(0, nbc, size=int(indptr[-1]))
    data = rng.standard_normal((len(indices), b, b))
    J = jsp.BSR(jnp.asarray(data), indices, indptr, (nbr * b, nbc * b), b)
    T = interop.bsr_from_numpy(data, indices, indptr, (nbr * b, nbc * b), b,
                               device="cpu")
    return J, T, data


@pytest.mark.parametrize("b", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_bsr_scalar_pattern_equals_jax(b, seed):
    rng = np.random.default_rng(seed)
    J, T, data = _irregular_pair(rng, 9, 7, b)
    ours = tspmv.bsr_scalar_pattern(T)
    ref = jps.bsr_scalar_pattern(J)
    for got, want in zip(ours, ref):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    x = rng.standard_normal(7 * b)
    dense = np.zeros(T.shape)
    for k, (i, j) in enumerate(zip(T.block_row_ids, T.indices)):
        dense[i * b:(i + 1) * b, j * b:(j + 1) * b] += data[k]
    ref_y = np.asarray(J.matvec(jnp.asarray(x)))
    _close(ref_y, dense @ x)
    if b == 2 and seed == 0:        # the JAX K5 in interpret mode, once
        _close(np.asarray(jps.bsr_spmv_pallas(J, jnp.asarray(x),
                                              interpret=True)), ref_y)
    _close(_np(tspmv.bsr_spmv(T, torch.tensor(x))), ref_y)
    _close(_np(T.matvec(torch.tensor(x))), ref_y)


# ---------------------------------------------------------------------------
# K6: bsr_spmm
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def spmm_case():
    """tests/test_pallas_spmv.py:166-183's matrix: b 4, 64 block rows."""
    rng = np.random.default_rng(5)
    b, nb = 4, 64
    dense = np.zeros((nb * b, nb * b))
    for i in range(nb):
        for j in rng.choice(nb, size=int(rng.integers(1, 5)), replace=False):
            dense[i * b:(i + 1) * b, j * b:(j + 1) * b] = \
                rng.standard_normal((b, b))
    return dense, jsp.BSR.from_csr(jsp.CSR.from_dense(dense), b), rng


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nrhs", [1, 8, 37])
def test_bsr_spmm_equals_jax(spmm_case, nrhs, dtype):
    dense, J, rng = spmm_case
    J = J.with_data(J.data.astype(NP_DT[dtype]))
    T = interop.bsr_from_numpy(np.asarray(J.data), J.indices, J.indptr,
                               J.shape, J.blocksize, device="cpu")
    X = rng.standard_normal((dense.shape[1], nrhs)).astype(NP_DT[dtype])
    plain = tspmv.bsr_spmm_plain(T, torch.tensor(X))
    assert plain.dtype == T.data.dtype and plain.shape == (dense.shape[0],
                                                            nrhs)
    for interpret in (True, False):
        ref = np.asarray(jps.bsr_spmm_pallas(J, jnp.asarray(X),
                                             interpret=interpret))
        assert ref.dtype == NP_DT[dtype]
        _close(_np(plain), ref, RTOL[dtype])
    _close(_np(plain), dense @ X.astype(np.float64), RTOL[dtype])
    assert torch.equal(tspmv.bsr_spmm(T, torch.tensor(X)), plain)


def test_bsr_spmm_edges():
    """An empty block row gives zero rows; nrhs 0 an empty Y; a NaN in X
    reaches every row whose block row references it, through the explicit
    zeros of the blocks too; mixed dtypes raise."""
    rng = np.random.default_rng(2)
    A = _block_dense(rng, 6, 6, 3, empty_row=4)
    T = tsp.BSR.from_csr(tsp.CSR.from_dense(A, device="cpu"), 3)
    X = torch.tensor(rng.standard_normal((18, 5)))
    Y = tspmv.bsr_spmm(T, X)
    assert bool((Y[12:15] == 0).all())
    assert tspmv.bsr_spmm(T, X[:, :0]).shape == (18, 0)
    Xn = X.clone()
    Xn[7, 2] = float("nan")                     # block column 2
    rows = np.repeat(T.block_row_ids[T.indices == 2] * 3, 3) + np.tile(
        np.arange(3), int((T.indices == 2).sum()))
    nan = torch.isnan(tspmv.bsr_spmm(T, Xn))
    expect = torch.zeros_like(nan)
    expect[torch.as_tensor(rows), 2] = True
    assert torch.equal(nan, expect)
    with pytest.raises(TypeError):
        tspmv.bsr_spmm(T, X.float())
    with pytest.raises(ValueError):
        tspmv.bsr_spmm(T, X[:9])


def test_k6_times_colour_seeds_is_the_compressed_jacobian():
    """At N = 16, the colored Jacobian (as CSR, reblocked with b = 2) times
    the colour seeds gives the compressed JVPs bit for bit, in the port and
    in the JAX package's K6 (interpret mode) on the same data."""
    N = 16
    n = 2 * N * N
    pat = tbru.sparsity_pattern(N)
    plan = plan_sparse_jacobian(None, n, n, sparsity=pat)
    gen = torch.Generator().manual_seed(3)
    u = (tbru.init_u0(N, torch.float64, device="cpu").reshape(-1)
         + 0.1 * torch.randn(n, generator=gen, dtype=torch.float64))
    p = tbru.default_p(N, torch.float64, device="cpu")

    def f(v):
        return tbru.brusselator_2d(v.reshape(N, N, 2), p).reshape(-1)

    compressed = plan._compressed(f, u)
    Jb = tsp.BSR.from_csr(plan(f, u), 2)
    assert len(Jb.indices) == 5 * N * N
    S = torch.tensor(plan._seeds.T.copy())
    Y = tspmv.bsr_spmm(Jb, S)
    assert torch.equal(Y, compressed.T)
    Jj = jsp.BSR(jnp.asarray(_np(Jb.data)), Jb.indices, Jb.indptr, Jb.shape,
                 2)
    ref = np.asarray(jps.bsr_spmm_pallas(Jj, jnp.asarray(_np(S)),
                                         interpret=True))
    np.testing.assert_array_equal(ref, _np(Y))


# ---------------------------------------------------------------------------
# preconditioners
# ---------------------------------------------------------------------------

def test_preconditioners_equal_jax():
    rng = np.random.default_rng(2)
    # TestBSR.test_block_jacobi_feed's case
    A = np.zeros((10, 10))
    for i in range(5):
        for j in range(5):
            if i == j or rng.random() < 0.3:
                A[2 * i:2 * i + 2, 2 * j:2 * j + 2] = \
                    rng.standard_normal((2, 2))
    A += np.eye(10) * 5.0
    J = jsp.BSR.from_csr(jsp.CSR.from_dense(A), 2)
    T = tsp.BSR.from_csr(tsp.CSR.from_dense(A, device="cpu"), 2)
    v = np.random.default_rng(3).standard_normal(10)
    ref = np.asarray(jpre.block_jacobi_preconditioner(J.diag_blocks())(
        jnp.asarray(v)))
    M = tpre.block_jacobi_preconditioner(T.diag_blocks())
    _close(_np(M(torch.tensor(v))), ref)
    _close(_np(M(torch.tensor(v).reshape(5, 2))).reshape(-1), ref)
    expected = np.concatenate([np.linalg.solve(A[2 * i:2 * i + 2,
                                                 2 * i:2 * i + 2],
                                               v[2 * i:2 * i + 2])
                               for i in range(5)])
    _close(ref, expected, 1e-10)
    d = np.diag(A).copy()
    d[3] = 0.0
    np.testing.assert_array_equal(
        _np(tpre.jacobi_preconditioner(torch.tensor(d))(torch.tensor(v))),
        np.asarray(jpre.jacobi_preconditioner(jnp.asarray(d))(
            jnp.asarray(v))))

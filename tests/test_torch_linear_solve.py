"""The dense linear solves of the port (``ops/linear_solve.py``) against the
JAX package's, f64 on the CPU, on the same numpy matrices.

- ``gauss_jordan_solve`` (n = 1, 4, 10, 32, a vector and a block of
  right-hand sides, with a zero column and a NaN): bit for bit equal to the
  JAX function, by both of its routes (the host helper that CPU tensors
  take and the tensor operations that the card runs).
- ``solve_dense`` for every method, ``solve_spd`` and ``_lstsq`` on
  random, singular, rank-deficient and non-SPD matrices: the same ``ok``,
  and rel-inf 1e-12 where both results are finite.  The singular matrices
  have an exactly zero column: their ridge-fallback solutions are then as
  well conditioned as the rest of the matrix (a singular matrix with a
  dense null space gives a ridge solution whose null-space part is
  cond ≈ 1/√eps times the rounding of Aᵀb, so no two summation orders
  agree to 1e-12 on it).
- the deferred fallback: inside ``deferred_fallbacks()`` a singular
  system gives non-finite values, ``ok = False`` and a set flag, and
  reads nothing.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinearsolve_tpu.ops import linear_solve as jls
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.ops import linear_solve as tls

torch.set_num_threads(2)

RTOL = 1e-12


def _rng(seed):
    return np.random.default_rng(seed)


def _same(a, b):
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


def _rel_inf(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max()
                 / max(np.abs(ref).max(), 1e-300))


@pytest.mark.parametrize("n", [1, 4, 10, 32])
@pytest.mark.parametrize("nrhs", [None, 3])
def test_gauss_jordan_bit_equal(n, nrhs):
    rng = _rng(n * 7 + (nrhs or 0))
    A = rng.standard_normal((n, n)) * 10.0 ** rng.integers(-3, 4, (n, 1))
    b = rng.standard_normal(n if nrhs is None else (n, nrhs))
    want = np.asarray(jls.gauss_jordan_solve(jnp.asarray(A), jnp.asarray(b)))
    got = tls.gauss_jordan_solve(torch.tensor(A), torch.tensor(b)).numpy()
    assert _same(got, want)
    B = torch.tensor(b)
    M = torch.cat([torch.tensor(A), B[:, None] if nrhs is None else B], -1)
    ops = tls._gauss_jordan_ops(M, n, nrhs is None).numpy()
    assert _same(ops, want)


@pytest.mark.parametrize("case", ["zero_column", "nan", "float32"])
def test_gauss_jordan_edge_cases_bit_equal(case):
    rng = _rng(5)
    A = rng.standard_normal((6, 6))
    b = rng.standard_normal(6)
    if case == "zero_column":
        A[:, 3] = 0.0
    elif case == "nan":
        A[2, 4] = np.nan
    else:
        A, b = A.astype(np.float32), b.astype(np.float32)
    want = np.asarray(jls.gauss_jordan_solve(jnp.asarray(A), jnp.asarray(b)))
    got = tls.gauss_jordan_solve(torch.tensor(A), torch.tensor(b)).numpy()
    ops = tls._gauss_jordan_ops(
        torch.cat([torch.tensor(A), torch.tensor(b)[:, None]], -1), 6,
        True).numpy()
    assert _same(got, want) and _same(ops, want)
    if case != "float32":
        assert not np.isfinite(want).all()


def _matrix(kind, n, rng):
    A = rng.standard_normal((n, n))
    if kind == "spd":
        return A @ A.T + n * np.eye(n)
    if kind == "singular":
        A[:, 1] = 0.0
    elif kind == "non_spd":
        A = A + A.T
        A[0, 0] = -abs(A[0, 0]) - n        # an indefinite symmetric matrix
    return A


@pytest.mark.parametrize("method", ["auto", "lu", "qr", "cholesky", "svd",
                                    "diagonal"])
@pytest.mark.parametrize("kind,n", [("random", 6), ("random", 40),
                                    ("spd", 6), ("spd", 40),
                                    ("singular", 6), ("singular", 40),
                                    ("non_spd", 6)])
def test_solve_dense_matches_jax(method, kind, n):
    rng = _rng(zlib.crc32(f"{method}-{kind}-{n}".encode()))
    A = _matrix(kind, n, rng)
    b = rng.standard_normal(n)
    xj, okj = jls.solve_dense(jnp.asarray(A), jnp.asarray(b),
                              jls.LinearSolver(method=method))
    xt, okt = tls.solve_dense(torch.tensor(A), torch.tensor(b),
                              tls.LinearSolver(method=method))
    assert bool(okj) == bool(okt)
    xj = np.asarray(xj)
    if bool(okj):
        assert _rel_inf(xt.numpy(), xj) <= RTOL
    else:
        assert not np.isfinite(xt.numpy()).all()


@pytest.mark.parametrize("shape", [(3, 2), (8, 5), (5, 8)])
@pytest.mark.parametrize("rank_deficient", [False, True])
def test_lstsq_matches_jax(shape, rank_deficient):
    rng = _rng(shape[0] * 10 + shape[1] + rank_deficient)
    A = rng.standard_normal(shape)
    if rank_deficient:
        A[:, -1] = 2.0 * A[:, 0]
    b = rng.standard_normal(shape[0])
    want, *_ = jnp.linalg.lstsq(jnp.asarray(A), jnp.asarray(b), rcond=None)
    got, _ = tls._lstsq(torch.tensor(A), torch.tensor(b))
    assert _rel_inf(got.numpy(), want) <= RTOL
    # the non-square route of solve_dense is the same least squares
    xq, okq = tls.solve_dense(torch.tensor(A), torch.tensor(b))
    xj, okj = jls.solve_dense(jnp.asarray(A), jnp.asarray(b))
    assert bool(okq) == bool(okj)
    assert _rel_inf(xq.numpy(), xj) <= RTOL


def test_lstsq_reuses_its_factors_exactly():
    rng = _rng(3)
    A = torch.tensor(rng.standard_normal((7, 4)))
    b1, b2 = (torch.tensor(rng.standard_normal(7)) for _ in range(2))
    _, factors = tls._lstsq(A, b1)
    again, _ = tls._lstsq(A, b2, factors)
    assert torch.equal(again, tls._lstsq(A, b2)[0])


def test_lstsq_nonfinite_input_gives_nan():
    A = torch.ones(4, 3, dtype=torch.float64)
    A[1, 2] = float("inf")
    x, _ = tls._lstsq(A, torch.ones(4, dtype=torch.float64))
    assert torch.isnan(x).all()


@pytest.mark.parametrize("kind", ["spd", "non_spd", "singular"])
def test_solve_spd_matches_jax(kind):
    rng = _rng(11)
    A = _matrix(kind, 7, rng)
    b = rng.standard_normal(7)
    xj, okj = jls.solve_spd(jnp.asarray(A), jnp.asarray(b))
    xt, okt = tls.solve_spd(torch.tensor(A), torch.tensor(b))
    assert bool(okj) == bool(okt)
    assert _rel_inf(xt.numpy(), xj) <= RTOL


def test_deferred_fallback_reads_nothing_and_flags():
    rng = _rng(2)
    A = torch.tensor(_matrix("singular", 5, rng))
    b = torch.tensor(rng.standard_normal(5))
    syncs = _backend.HOST_SYNCS["n"]
    with tls.deferred_fallbacks() as flags:
        x, ok = tls.solve_dense(A, b)
        y, oky = tls.solve_spd(torch.tensor(_matrix("non_spd", 5, rng)), b)
    assert _backend.HOST_SYNCS["n"] == syncs
    assert not bool(ok) and not torch.isfinite(x).all()
    assert not bool(oky) and not torch.isfinite(y).all()
    assert [bool(f) for f in flags] == [True, True]
    with tls.recorded_fallbacks() as outcomes:
        x2, ok2 = tls.solve_dense(A, b)
    assert outcomes == [True] and bool(ok2) and torch.isfinite(x2).all()
    # a regular system wants no fallback
    with tls.deferred_fallbacks() as flags:
        tls.solve_dense(torch.eye(5, dtype=torch.float64), b)
    assert [bool(f) for f in flags] == [False]


def test_unknown_method_raises():
    with pytest.raises(ValueError):
        tls.solve_dense(torch.eye(2, dtype=torch.float64),
                        torch.ones(2, dtype=torch.float64),
                        tls.LinearSolver(method="nope"))

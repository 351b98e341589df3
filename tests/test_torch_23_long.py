"""The cases of ``test_torch_23_qn.py``'s rows that take 1000 steps or
more in the JAX package (``LONG``): each held as the short cases are, the
two broken-set knife-edges (``BROKEN_KNIFE_EDGES``) on the other side.
And the measurements the exemptions name: the JAX package's own runs
from a start moved a few ulps (``ULP_MOVES``) and the reference-formula
oracle's runs (``ORACLE``).
About six minutes serial (DFSane's 10000-step runs, the default ladder's
three rungs of up to 10000 steps), so the quick tier skips this file, as
it skips ``tests/test_23_problems.py``.  ``tests/test_torch_cuda.py``
runs the same cases on the card."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
from nonlinearsolve_tpu.models.problems23 import PROBLEMS_23 as JPROBLEMS
from test_torch_23_qn import (ORACLE, ROWS, ULP_MOVES, cases,
                              check_against_jax, ids)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from tools.oracle_qn import reference_broyden, reference_klement  # noqa

pytestmark = pytest.mark.slow

torch.set_num_threads(1)

CASES_HERE = cases(*ROWS, long=True)


@pytest.mark.parametrize("row,index", CASES_HERE, ids=ids(CASES_HERE))
def test_long_cases_against_jax(row, index):
    check_against_jax(row, index)


@pytest.mark.parametrize("row,index", sorted(ULP_MOVES),
                         ids=ids(sorted(ULP_MOVES)))
def test_jax_count_moves_with_the_start(row, index):
    k, ulps, retcode, nsteps = ULP_MOVES[(row, index)]
    make = ROWS[row][0]
    jp = JPROBLEMS[index - 1]
    x = jp.start.copy()
    for _ in range(ulps):
        x[k] = np.nextafter(x[k], np.inf)
    prob = jnls.NonlinearProblem(jp.f, jnp.asarray(x))
    sol = (jnls.solve(prob, maxiters=10000) if make is None
           else jnls.solve(prob, make(jnls), maxiters=10000))
    assert (int(sol.retcode), int(sol.stats.nsteps)) == (retcode, nsteps)


@pytest.mark.parametrize("row,index", sorted(ORACLE), ids=ids(sorted(ORACLE)))
def test_oracle_counts(row, index):
    jp = JPROBLEMS[index - 1]
    ff = jax.jit(lambda x: jp.f(x, None))

    def f(u):
        return np.asarray(ff(np.asarray(u, np.float64)), np.float64)

    oracle = reference_broyden if row == "Broyden" else reference_klement
    record = []
    out = oracle(f, jp.start, maxiters=10000, record=record)
    assert (out["retcode"], len(record)) == ORACLE[(row, index)]

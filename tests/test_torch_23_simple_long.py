"""The cases of ``test_torch_23_simple.py``'s rows that take 1000 steps or
more in the JAX package (``LONG``), each held as the short cases are, and
the JAX package's own runs from moved starts behind its knife-edges
(``ULP_MOVES``).  About fifteen minutes serial (SimpleDFSane's 10000-step
runs count about 200,000 residuals each, one host read a line-search
trial), so the quick tier skips this file, as it skips
``tests/test_23_problems.py``.  ``chip_smoke.py`` phase 22 runs the short
cases on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
from nonlinearsolve_tpu.models.problems23 import PROBLEMS_23 as JPROBLEMS
from test_torch_23_simple import (ROWS, ULP_MOVES, cases, check_against_jax,
                                  ids)

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
    jp = JPROBLEMS[index - 1]
    x = jp.start.copy()
    for _ in range(ulps):
        x[k] = np.nextafter(x[k], np.inf)
    sol = jnls.solve(jnls.NonlinearProblem(jp.f, jnp.asarray(x)),
                     ROWS[row][0](jnls), maxiters=10000)
    assert (int(sol.retcode), int(sol.stats.nsteps)) == (retcode, nsteps)

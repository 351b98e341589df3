"""LimitedMemoryBroyden on the 23 problems (below its threshold: plain
Broyden) and the two ``LARGE_N_CASES`` rows of ``tests/test_23_problems.py``
at n = 64, where the rank-27 ring carries every step, on the port against
the JAX package (see ``test_torch_23_qn.py``)."""

import pytest
import torch

from test_torch_23_qn import (LARGE_N_INDICES, LARGE_N_ROWS, cases,
                              check_against_jax, check_large_n, ids)

torch.set_num_threads(1)

CASES_HERE = cases("LimitedMemoryBroyden")
LARGE = [(r, i) for r in LARGE_N_ROWS for i in LARGE_N_INDICES]


@pytest.mark.parametrize("row,index", CASES_HERE, ids=ids(CASES_HERE))
def test_limited_memory_broyden_row_against_jax(row, index):
    check_against_jax(row, index)


@pytest.mark.parametrize("row,index", LARGE, ids=ids(LARGE))
def test_large_n_ring_rows_against_jax(row, index):
    check_large_n(row, index)

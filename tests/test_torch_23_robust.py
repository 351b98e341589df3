"""RobustMultiNewton on problems 1–12 of the 23 (the row of
``tests/test_23_problems.py`` CASES with no broken problem) on the port
against the JAX package (see ``test_torch_23_qn.py``; problems 13–23 are
in ``test_torch_23_robust_late.py``: the JAX package compiles six rungs a
problem)."""

import pytest
import torch

from test_torch_23_qn import cases, check_against_jax, ids

torch.set_num_threads(1)

CASES_HERE = [c for c in cases("RobustMultiNewton") if c[1] <= 12]


@pytest.mark.parametrize("row,index", CASES_HERE, ids=ids(CASES_HERE))
def test_robust_multi_newton_against_jax(row, index):
    check_against_jax(row, index)

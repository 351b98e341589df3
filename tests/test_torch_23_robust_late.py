"""RobustMultiNewton on problems 13–23 of the 23 on the port against the
JAX package (see ``test_torch_23_robust.py``)."""

import pytest
import torch

from test_torch_23_qn import cases, check_against_jax, ids

torch.set_num_threads(1)

CASES_HERE = [c for c in cases("RobustMultiNewton") if c[1] > 12]


@pytest.mark.parametrize("row,index", CASES_HERE, ids=ids(CASES_HERE))
def test_robust_multi_newton_against_jax(row, index):
    check_against_jax(row, index)

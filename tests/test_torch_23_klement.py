"""The Klement, Klement-TrueJacDiagonal and DFSane rows of
``tests/test_23_problems.py`` CASES on the port against the JAX package
(see ``test_torch_23_qn.py``; their many cases of 1000 steps or more are
in ``test_torch_23_long.py``)."""

import pytest
import torch

from test_torch_23_qn import cases, check_against_jax, ids

torch.set_num_threads(1)

CASES_HERE = cases("Klement", "Klement-TrueJacDiagonal", "DFSane")


@pytest.mark.parametrize("row,index", CASES_HERE, ids=ids(CASES_HERE))
def test_klement_and_dfsane_rows_against_jax(row, index):
    check_against_jax(row, index)

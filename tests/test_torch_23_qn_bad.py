"""The bad-Broyden rows of ``tests/test_23_problems.py`` CASES on the
port against the JAX package (see ``test_torch_23_qn.py``)."""

import pytest
import torch

from test_torch_23_qn import cases, check_against_jax, ids

torch.set_num_threads(1)

CASES_HERE = cases("Broyden-BadBroyden", "Broyden-TrueJacobian-Bad")


@pytest.mark.parametrize("row,index", CASES_HERE, ids=ids(CASES_HERE))
def test_bad_broyden_rows_against_jax(row, index):
    check_against_jax(row, index)

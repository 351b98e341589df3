"""The 23-problem suite on the port's simple tier, the cases of under 1000
JAX steps of the SimpleHalley and SimpleLimitedMemoryBroyden rows, held as
``test_torch_23_simple.py`` holds the others (its ``EXEMPT`` names the
cases whose counts rounding decides)."""

import pytest
import torch

from test_torch_23_simple import cases, check_against_jax, ids

torch.set_num_threads(1)

CASES_HERE = cases("SimpleHalley", "SimpleLimitedMemoryBroyden")


@pytest.mark.parametrize("row,index", CASES_HERE, ids=ids(CASES_HERE))
def test_simple_rows_against_jax(row, index):
    check_against_jax(row, index)

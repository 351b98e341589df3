"""Broyden with a trust region and LimitedMemoryBroyden with a history of
two — the rows of ``tests/test_23_problems.py`` CASES that exercise the
quasi-Newton trust-region path and the low-rank ring on the small
problems — on the port against the JAX package (see
``test_torch_23_qn.py``)."""

import pytest
import torch

from test_torch_23_qn import cases, check_against_jax, ids

torch.set_num_threads(1)

CASES_HERE = cases("Broyden-TrustRegion", "LimitedMemoryBroyden-thresh2")


@pytest.mark.parametrize("row,index", CASES_HERE, ids=ids(CASES_HERE))
def test_trust_region_and_ring_rows_against_jax(row, index):
    check_against_jax(row, index)

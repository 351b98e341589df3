"""``solve(prob)`` with no algorithm — the default polyalgorithm (Broyden →
Klement → NewtonRaphson → TrustRegion → TrustRegion(Fan) →
LevenbergMarquardt, from Broyden at every size) — on the 23 problems: the
DefaultPolyalgorithm row of ``tests/test_23_problems.py`` CASES (no broken
problem; BASELINE config 2) on the port against the JAX package (see
``test_torch_23_qn.py``; the cases whose rungs take 1000 steps or more
are in ``test_torch_23_long.py``)."""

import pytest
import torch

from test_torch_23_qn import cases, check_against_jax, ids

torch.set_num_threads(1)

CASES_HERE = cases("DefaultPolyalgorithm")


@pytest.mark.parametrize("row,index", CASES_HERE, ids=ids(CASES_HERE))
def test_default_polyalgorithm_against_jax(row, index):
    check_against_jax(row, index)

"""The 23-problem suite with TrustRegion (the simple scheme) against the
JAX package's own runs (see ``test_torch_23_problems.py``)."""

import pytest
import torch

from test_torch_23_problems import INDICES, check_against_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("index", INDICES)
def test_trust_region_against_jax(index):
    check_against_jax("TrustRegion", index)

"""The 23-problem suite with PseudoTransient(alpha_initial=10.0) against
the JAX package's own runs, problems 10–23 (see
``test_torch_23_pseudo.py``)."""

import pytest
import torch

from test_torch_23_problems import check_against_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("index", range(10, 24))
def test_pseudo_transient_against_jax(index):
    check_against_jax("PseudoTransient", index)

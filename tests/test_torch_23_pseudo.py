"""The 23-problem suite with PseudoTransient(alpha_initial=10.0) against
the JAX package's own runs (see ``test_torch_23_problems.py``), problems
1–9; ``test_torch_23_pseudo_late.py`` runs 10–23.  Its broken problems
(1, 8, 11) each run the full 10000 steps in both packages, so the row
spans two files."""

import pytest
import torch

from test_torch_23_problems import check_against_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("index", range(1, 10))
def test_pseudo_transient_against_jax(index):
    check_against_jax("PseudoTransient", index)

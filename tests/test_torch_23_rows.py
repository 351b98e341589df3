"""The slice's other rows of ``tests/test_23_problems.py`` CASES —
TrustRegion with the Fan, NLsolve, Bastin, Hei and Yuan schemes,
LevenbergMarquardt with α_geodesic = 0.1 and with a Cholesky solver,
NewtonRaphson with BackTracking — in the port alone, each held to the
literal broken set of that file (see ``test_torch_23_problems.py``)."""

import pytest
import torch

from test_torch_23_problems import INDICES, OTHER_ROWS, check_port_row

torch.set_num_threads(1)

ROW_CASES = [(row, i) for row in OTHER_ROWS for i in INDICES]


@pytest.mark.parametrize("row,index", ROW_CASES,
                         ids=[f"{r}-{i}" for r, i in ROW_CASES])
def test_other_rows_broken_sets(row, index):
    check_port_row(row, index)

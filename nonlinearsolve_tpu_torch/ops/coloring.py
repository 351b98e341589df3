"""Sparsity patterns and graph coloring for compressed Jacobians (the port
of ``ops/coloring.py``).

- ``pattern_from``: a user's sparsity spec (a ``CSR``, a COO ``(rows,
  cols)`` tuple, or a dense mask) as a CSR pattern.
- ``greedy_column_coloring``: distance-2 greedy coloring of the column
  graph (two columns conflict iff they share a row), through the native
  toolkit (``native.py``).  ``greedy_column_coloring_py`` is the same
  algorithm in Python: the executable specification, which runs only when
  called by name.

Sparsity detection (the JAX package's ``detect_sparsity`` and its jaxpr
tracer) is ROADMAP A.25: until then a sparse Jacobian needs ``sparsity``
or ``jac_prototype`` on the ``NonlinearFunction``.
"""

from __future__ import annotations

import numpy as np
import torch

from .sparse import CSR


def pattern_from(obj, n_out: int, n_in: int) -> CSR:
    """Normalize a sparsity spec (CSR, COO (rows, cols) tuple, or dense
    mask) to a CSR pattern."""
    if isinstance(obj, CSR):
        return obj
    if isinstance(obj, tuple) and len(obj) == 2:
        rows = np.asarray(obj[0], np.int64)
        cols = np.asarray(obj[1], np.int64)
        if rows.ndim == 1 and cols.ndim == 1 and rows.shape == cols.shape:
            if (rows.size and (rows.min() < 0 or rows.max() >= n_out
                               or cols.min() < 0 or cols.max() >= n_in)):
                raise ValueError(
                    f"COO sparsity indices out of range for a "
                    f"({n_out}, {n_in}) jacobian")
            return CSR.from_pattern(rows, cols, (n_out, n_in))
    arr = (obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor)
           else np.asarray(obj))
    if arr.shape != (n_out, n_in):
        raise ValueError(
            f"sparsity spec shape {arr.shape} does not match the "
            f"({n_out}, {n_in}) jacobian; pass a dense mask, a CSR "
            f"pattern, or a (rows, cols) COO tuple")
    rows, cols = np.nonzero(arr != 0)
    return CSR.from_pattern(rows, cols, (n_out, n_in))


def greedy_column_coloring(pattern: CSR) -> np.ndarray:
    """Greedy distance-2 column coloring through the native toolkit
    (raises if it does not build)."""
    from ..native import greedy_column_coloring as native_coloring
    n_rows, n_cols = pattern.shape
    return native_coloring(pattern.indptr, pattern.indices, n_rows, n_cols)


def greedy_column_coloring_py(pattern: CSR) -> np.ndarray:
    """The same coloring in Python (the executable specification)."""
    n_rows, n_cols = pattern.shape
    indices = pattern.indices
    row_ids = pattern.row_ids
    rows_of_col = [[] for _ in range(n_cols)]
    cols_in_row = [[] for _ in range(n_rows)]
    for k in range(len(indices)):
        rows_of_col[indices[k]].append(row_ids[k])
        cols_in_row[row_ids[k]].append(indices[k])
    colors = np.full(n_cols, -1, np.int32)
    for j in range(n_cols):
        forbidden = set()
        for r in rows_of_col[j]:
            for k in cols_in_row[r]:
                if colors[k] >= 0:
                    forbidden.add(int(colors[k]))
        c = 0
        while c in forbidden:
            c += 1
        colors[j] = c
    return colors

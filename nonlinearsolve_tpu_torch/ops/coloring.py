"""Sparsity patterns and graph coloring for compressed Jacobians (the port
of ``ops/coloring.py``).

- ``pattern_from``: a user's sparsity spec (a ``CSR``, a COO ``(rows,
  cols)`` tuple, or a dense mask) as a CSR pattern.
- ``greedy_column_coloring``: distance-2 greedy coloring of the column
  graph (two columns conflict iff they share a row), through the native
  toolkit (``native.py``).  ``greedy_column_coloring_py`` is the same
  algorithm in Python: the executable specification, which runs only when
  called by name.

- ``detect_sparsity``: the Jacobian's pattern when the user gives none —
  the exact ATen-graph tracer (``ops/sparsity_trace.py``) first, else the
  union of ``|J| > 0`` over random-probe dense Jacobians at small sizes.
"""

from __future__ import annotations

import numpy as np
import torch

from .sparse import CSR


def detect_sparsity(f_flat, n: int, *, n_probes: int = 2, seed: int = 0,
                    dtype=torch.float64, device=None) -> CSR:
    """A CSR *pattern* of the Jacobian of ``f_flat`` at a flat state of
    ``n`` elements on ``device`` (the card when None).

    Tries the EXACT graph tracer first (no probabilistic misses); falls
    back to the union of ``jacfwd`` patterns at ``n_probes`` random
    points (``np.random.default_rng(seed)``, as the JAX package draws
    them) when the trace fails or uses an op the tracer does not support,
    and refuses when that dense probe would be too large."""
    from .. import _backend
    from .sparsity_trace import detect_sparsity_exact
    dev = _backend.resolve_device(device)
    dt = _backend.resolve_dtype(dtype)
    exact = detect_sparsity_exact(f_flat, n, dtype=dt, device=dev)
    if exact is not None:
        return exact
    n_out = f_flat(torch.zeros((n,), dtype=dt, device=dev)).numel()
    if n * max(n_out, 1) > 16_777_216:
        raise ValueError(
            "sparsity detection fell back to dense jacobian probing (the "
            "residual uses an op the exact graph tracer does not "
            f"support), but a dense ({n_out}, {n}) probe is infeasible at "
            "this size.  Pass the pattern explicitly via "
            "NonlinearFunction(sparsity=...) or jac_prototype=..., or use "
            "a matrix-free Krylov linear solver instead of a concrete "
            "sparse jacobian.")
    rng = np.random.default_rng(seed)
    mask = None
    for _ in range(n_probes):
        u = torch.as_tensor(rng.standard_normal(n) * 0.5 + 0.3, dtype=dt,
                            device=dev)
        m = (torch.func.jacfwd(f_flat)(u) != 0).reshape(n_out, n).cpu()
        mask = m if mask is None else (mask | m)
    rows, cols = np.nonzero(mask.numpy())
    return CSR.from_pattern(rows, cols, tuple(mask.shape))


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

"""Jacobian policy (the port of ``core/autodiff.py``'s ``JacobianPolicy``:
its fields and ``mode``).  Dense forward / reverse / finite-difference
Jacobians are ROADMAP A.32."""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class JacobianPolicy:
    """mode: 'auto' | 'forward' | 'reverse' | 'finite' | 'analytic' |
    'operator' | 'sparse'.  The port builds the matrix-free operator
    ('operator', or 'auto' with a Krylov linear solver) and the colored
    sparse-AD Jacobian ('sparse', or 'auto' with a sparsity pattern and a
    non-Krylov solver)."""

    mode: str = "auto"
    fd_rel_step: Optional[float] = None
    chunk_size: Optional[int] = None

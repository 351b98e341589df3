"""Linear-solver selection (the port of ``ops/linear_solve.py``'s
``LinearSolver`` config).  Only the Krylov route is ported; the dense
LU / QR routes are ROADMAP A.32."""

from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class LinearSolver:
    """Static linear-solver selection.

    method: 'auto' | 'lu' | 'qr' | 'cholesky' | 'svd' | 'diagonal'
            | 'gmres' | 'bicgstab' | 'cg' | 'minres' | 'sparse_lu_device'.
    Of these the port runs 'gmres'; the others raise where they are used.
    ``precond_fn(u) -> (v -> M⁻¹v)`` is rebuilt at each Newton step; a
    plain ``v -> M⁻¹v`` callable is accepted too.
    ``krylov_basis_dtype`` ('bf16', 'bfloat16' or 'f16') stores the GMRES
    basis in that dtype (``ops.krylov.gmres(basis_dtype=)``).
    """

    method: str = "auto"
    restart: int = 20
    krylov_maxiter: Optional[int] = None
    precond: str = "none"
    precond_fn: Any = None
    krylov_basis_dtype: Optional[str] = None

    @property
    def is_krylov(self) -> bool:
        return self.method in ("gmres", "bicgstab", "cg", "minres")

"""Problem types (the port of ``core/problems.py``): ``NonlinearFunction``,
``NonlinearProblem`` and ``NonlinearLeastSquaresProblem``.

Functions are out-of-place: ``f(u, p) -> resid`` on tensors.  ``u`` is one
tensor of any shape (≥ 1-d); pytrees of tensors are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional


@dataclasses.dataclass(frozen=True, eq=False)
class NonlinearFunction:
    """Residual function plus optional analytic derivative information.
    Compared and hashed by identity: the sparse Jacobian plan is cached
    per function object (``core/solve.py``).

    - ``f(u, p) -> resid``
    - ``jac(u, p) -> J``
    - ``jvp(v, u, p) -> J @ v``
    - ``vjp(v, u, p) -> J.T @ v``
    - ``sparsity`` / ``jac_prototype``: the Jacobian's sparsity pattern (a
      ``CSR`` pattern, a COO ``(rows, cols)`` tuple or a dense mask), for
      colored sparse-AD Jacobians
    - ``colorvec``: a precomputed column coloring of that pattern
    """

    f: Callable
    jac: Optional[Callable] = None
    jvp: Optional[Callable] = None
    vjp: Optional[Callable] = None
    jac_prototype: Any = None
    sparsity: Any = None
    colorvec: Any = None

    def __call__(self, u, p=None):
        return self.f(u, p)


def _wrap_function(f) -> NonlinearFunction:
    if isinstance(f, NonlinearFunction):
        return f
    return NonlinearFunction(f=f)


@dataclasses.dataclass(frozen=True)
class NonlinearProblem:
    """Find ``u`` with ``f(u, p) = 0`` (square system).

    ``kwargs`` are default solve options merged below call-site kwargs.
    ``lb``/``ub`` (bounds) are accepted so that a solve can refuse them.
    """

    f: NonlinearFunction
    u0: Any
    p: Any = None
    lb: Any = None
    ub: Any = None
    kwargs: dict = dataclasses.field(default_factory=dict)

    def __init__(self, f, u0, p=None, *, lb=None, ub=None, **kwargs):
        object.__setattr__(self, "f", _wrap_function(f))
        object.__setattr__(self, "u0", u0)
        object.__setattr__(self, "p", p)
        object.__setattr__(self, "lb", lb)
        object.__setattr__(self, "ub", ub)
        object.__setattr__(self, "kwargs", kwargs)

    @property
    def is_least_squares(self) -> bool:
        return False

    def remake(self, *, u0=None, p=None, f=None, **kwargs):
        new_kwargs = {**self.kwargs, **kwargs}
        return type(self)(
            f if f is not None else self.f,
            u0 if u0 is not None else self.u0,
            p if p is not None else self.p,
            lb=self.lb, ub=self.ub, **new_kwargs,
        )


class NonlinearLeastSquaresProblem(NonlinearProblem):
    """Minimize ``‖f(u, p)‖₂``; the residual may be non-square (m ≠ n)."""

    @property
    def is_least_squares(self) -> bool:
        return True

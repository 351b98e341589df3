"""Problem types (the port of ``core/problems.py``): ``NonlinearFunction``,
``NonlinearProblem``, ``NonlinearLeastSquaresProblem``,
``IntervalNonlinearProblem``, ``SteadyStateProblem``, ``HomotopyProblem``
and ``SCCNonlinearProblem``.

Functions are out-of-place: ``f(u, p) -> resid`` on tensors.  ``u`` is a
tensor of any shape, or a pytree of them (tuples, lists, dicts,
dataclasses; ``utils/pytree.py``), real or complex; the residual may be a
pytree too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence


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
    - ``resid_prototype``: a prototype of the residual; carried, read by
      no solver (as in the JAX package)
    - ``initialization_data``: an ``InitializationData`` whose sub-problem
      is solved before the main solve
    """

    f: Callable
    jac: Optional[Callable] = None
    jvp: Optional[Callable] = None
    vjp: Optional[Callable] = None
    jac_prototype: Any = None
    sparsity: Any = None
    colorvec: Any = None
    resid_prototype: Any = None
    initialization_data: Any = None

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
    ``lb``/``ub``: elementwise bounds (None, scalars or tensors), enforced
    by a change of variable (``core/bounds.py``).
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


@dataclasses.dataclass(frozen=True)
class IntervalNonlinearProblem:
    """Scalar root find on a bracket: ``f(u, p) = 0`` for ``u`` in
    ``tspan``, solved by the bracketing tier.

    The endpoints are Python floats or tensors; endpoints and ``p`` may be
    1-d tensors of length B, one problem a row (a batch, solved in
    lockstep).  ``f`` then runs under ``torch.func.vmap`` on one row at a
    time: a 0-d ``u`` with that row's ``p``.  A parameter that all rows
    share and that is itself a vector goes inside a tuple.
    """

    f: NonlinearFunction
    tspan: tuple
    p: Any = None
    kwargs: dict = dataclasses.field(default_factory=dict)

    def __init__(self, f, tspan, p=None, **kwargs):
        object.__setattr__(self, "f", _wrap_function(f))
        object.__setattr__(self, "tspan", tuple(tspan))
        object.__setattr__(self, "p", p)
        object.__setattr__(self, "kwargs", kwargs)

    def remake(self, *, tspan=None, p=None, f=None, **kwargs):
        return type(self)(f if f is not None else self.f,
                          tspan if tspan is not None else self.tspan,
                          p if p is not None else self.p,
                          **{**self.kwargs, **kwargs})


class SteadyStateProblem(NonlinearProblem):
    """The steady state of ``du/dt = f(u, p)``, solved as ``f(u, p) = 0``
    (``SSRootfind``) or by integrating the flow (``DynamicSS``).
    ``to_nonlinear`` keeps the problem's ``NonlinearFunction``, its
    analytic derivatives (a kernel ``jvp``) included."""

    def to_nonlinear(self) -> NonlinearProblem:
        return NonlinearProblem(self.f, self.u0, self.p, lb=self.lb,
                                ub=self.ub, **self.kwargs)


@dataclasses.dataclass(frozen=True)
class HomotopyProblem:
    """Continuation problem ``f(u, p, λ) = 0`` over ``λ ∈ lambdaspan``,
    solved by the methods of ``solvers/homotopy.py``.  ``f(u, p, lam) ->
    resid``; ``lam`` reaches it as a 0-d tensor of ``u0``'s dtype on
    ``u0``'s device."""

    f: NonlinearFunction
    u0: Any
    p: Any = None
    lambdaspan: tuple = (0.0, 1.0)
    kwargs: dict = dataclasses.field(default_factory=dict)

    def __init__(self, f, u0, p=None, lambdaspan=(0.0, 1.0), **kwargs):
        object.__setattr__(self, "f", _wrap_function(f))
        object.__setattr__(self, "u0", u0)
        object.__setattr__(self, "p", p)
        object.__setattr__(self, "lambdaspan", tuple(lambdaspan))
        object.__setattr__(self, "kwargs", kwargs)

    def remake(self, *, u0=None, p=None, f=None, lambdaspan=None, **kwargs):
        return type(self)(
            f if f is not None else self.f,
            u0 if u0 is not None else self.u0,
            p if p is not None else self.p,
            lambdaspan if lambdaspan is not None else self.lambdaspan,
            **{**self.kwargs, **kwargs})


@dataclasses.dataclass(frozen=True)
class SCCNonlinearProblem:
    """A sequence of strongly connected blocks solved in order
    (``solvers/scc.py``).  ``probs``: ``NonlinearProblem``,
    ``HomotopyProblem`` or ``LinearSCCBlock`` blocks; ``explicitfuns``:
    one ``fn(p, sols_so_far) -> p_block`` (or None) a block, run before
    its solve, which threads earlier blocks' solutions into later
    blocks' parameters."""

    probs: Sequence[Any]
    explicitfuns: Optional[Sequence[Callable]] = None
    p: Any = None
    kwargs: dict = dataclasses.field(default_factory=dict)

    def __init__(self, probs, explicitfuns=None, p=None, **kwargs):
        object.__setattr__(self, "probs", tuple(probs))
        object.__setattr__(self, "explicitfuns",
                           tuple(explicitfuns) if explicitfuns is not None
                           else None)
        object.__setattr__(self, "p", p)
        object.__setattr__(self, "kwargs", kwargs)

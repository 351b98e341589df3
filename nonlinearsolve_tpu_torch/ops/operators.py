"""Matrix-free Jacobian operators (the port of ``ops/operators.py``).

``JacobianOperator`` gives J·v and Jᵀ·v of ``f_flat`` without forming J:
the problem's analytic ``jvp`` / ``vjp`` when it has them (on the main
path, kernel K1 for J·v), else ``torch.func.jvp`` / ``torch.func.vjp`` of
the residual.  ``.T`` swaps the two (``VecJacOperator`` is the transposed
operator).  A ``StatefulJacobianOperator`` is one bound at a
linearisation point, a ``StatefulJacobianNormalFormOperator`` its JᵀJ.
On a complex state the VJP is ``torch.func.vjp``'s, Jᴴ·v.  ``mv`` / ``rmv`` apply J / Jᵀ whatever J is: a dense
matrix (with a shaped vector), a sparse container or an operator.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.autodiff import jvp as fwd_jvp


class JacobianOperator:
    """Lazy Jacobian of ``f_flat`` providing the JVP and the VJP."""

    def __init__(self, f_flat: Callable,
                 analytic_jvp: Optional[Callable] = None,
                 analytic_vjp: Optional[Callable] = None):
        self.f_flat = f_flat
        self.analytic_jvp = analytic_jvp
        self.analytic_vjp = analytic_vjp

    def jvp(self, u, v):
        if self.analytic_jvp is not None:
            return self.analytic_jvp(v, u)
        return fwd_jvp(self.f_flat, u, v)[1]

    def vjp(self, u, v):
        if self.analytic_vjp is not None:
            return self.analytic_vjp(v, u)
        return torch.func.vjp(self.f_flat, u)[1](v)[0]

    def at(self, u) -> "StatefulJacobianOperator":
        return StatefulJacobianOperator(self, u)

    @property
    def T(self) -> "TransposedJacobianOperator":
        return TransposedJacobianOperator(self)


class TransposedJacobianOperator:
    """Jᵀ of a ``JacobianOperator``: its products are the VJP and its
    transposed products the JVP."""

    def __init__(self, op: JacobianOperator):
        self.op = op

    def jvp(self, u, v):
        return self.op.vjp(u, v)

    def vjp(self, u, v):
        return self.op.jvp(u, v)

    def at(self, u) -> "StatefulJacobianOperator":
        return StatefulJacobianOperator(self, u)

    @property
    def T(self) -> JacobianOperator:
        return self.op


class StatefulJacobianOperator:
    """Operator bound to a linearization point — a drop-in ``matvec``."""

    def __init__(self, op, u):
        self.op = op
        self.u = u

    def __call__(self, v):
        return self.op.jvp(self.u, v)

    def rmatvec(self, v):
        return self.op.vjp(self.u, v)

    def __matmul__(self, v):
        return self(v)

    @property
    def T(self) -> "StatefulJacobianOperator":
        return StatefulJacobianOperator(self.op.T, self.u)


class StatefulJacobianNormalFormOperator:
    """Lazy ``JᵀJ`` (complex: ``JᴴJ``) at a linearization point, the VJP
    of the JVP: the operator of normal-form Krylov least squares."""

    def __init__(self, op, u):
        self.op = op
        self.u = u

    def __call__(self, v):
        return self.op.vjp(self.u, self.op.jvp(self.u, v))

    def __matmul__(self, v):
        return self(v)


def JacVecOperator(f_flat: Callable, u=None, *, analytic_jvp=None):
    """``v ↦ J(u)·v``: a JacobianOperator, bound at ``u`` when given."""
    op = JacobianOperator(f_flat, analytic_jvp=analytic_jvp)
    return op if u is None else op.at(u)


def VecJacOperator(f_flat: Callable, u=None, *, analytic_vjp=None):
    """``v ↦ J(u)ᵀ·v`` (``torch.func.vjp`` of the residual unless
    ``analytic_vjp`` is given): the transposed JacobianOperator, bound at
    ``u`` when given."""
    op = JacobianOperator(f_flat, analytic_vjp=analytic_vjp).T
    return op if u is None else op.at(u)


def as_matvec(A) -> Callable:
    """Normalize a dense matrix, a sparse container (CSR, DIA, ELL) or an
    operator to ``v -> A@v``."""
    if callable(A) and not isinstance(A, torch.Tensor):
        return A
    return lambda v: mv(A, v)


def mv(A, v):
    """``A @ v`` for a dense matrix (with a shaped ``v``), a sparse container
    (CSR, DIA, ELL; flat ``v``) or an operator."""
    from .sparse import CSR, DIA, ELL
    if isinstance(A, StatefulJacobianOperator):
        return A(v)
    if isinstance(A, (CSR, DIA, ELL)):
        return A.matvec(v)
    if v.dim() != 1:
        return (A @ v.reshape(-1)).reshape(v.shape)
    return A @ v


def rmv(A, v):
    """``Aᵀ @ v`` for a dense matrix (with a shaped ``v``; the result has
    ``v``'s shape, as the JAX package's), a sparse container (flat ``v``)
    or an operator.  For a complex ``A`` it is ``Aᴴ @ v``, as the
    operator's VJP (``torch.func.vjp``) gives it: the gradient of ½‖F‖²
    (the JAX package's dense product and VJP give ``Aᵀ @ v``)."""
    from .sparse import CSR, DIA, ELL
    if isinstance(A, StatefulJacobianOperator):
        return A.rmatvec(v)
    if isinstance(A, (CSR, DIA, ELL)):
        return A.rmatvec(v)
    At = A.mH if A.is_complex() else A.T
    if v.dim() != 1:
        return (At @ v.reshape(-1)).reshape(v.shape)
    return At @ v


def transpose_apply(adjoint, v):
    """``Aᵀ @ v`` from ``adjoint``, a callable ``v -> Aᴴ @ v`` (torch's
    products and VJPs conjugate): ``conj(Aᴴ conj v)`` on a complex ``v``,
    ``Aᴴ @ v`` on a real one.  It is the JAX package's unconjugated
    product and VJP, which its trust regions and Dogleg step along."""
    if not v.is_complex():
        return adjoint(v)
    return adjoint(v.conj()).conj()


def rmv_t(A, v):
    """``Aᵀ @ v`` with no conjugation: :func:`transpose_apply` of
    :func:`rmv`."""
    return transpose_apply(lambda w: rmv(A, w), v)

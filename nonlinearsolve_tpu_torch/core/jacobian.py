"""Jacobian construction (the port of ``core/jacobian.py``): the operator
route and the colored sparse-AD route.  The dense route is ROADMAP A.32."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ..ops.operators import JacobianOperator
from .autodiff import JacobianPolicy


@dataclasses.dataclass(frozen=True)
class JacobianSpec:
    """Problem-level derivative info (from NonlinearFunction)."""

    analytic_jvp: Optional[Callable] = None   # (v, u) -> J@v
    sparsity: Any = None                      # CSR pattern / COO / mask
    colorvec: Any = None
    sparse_plan: Any = None                   # host-built ColoredJacobian


def wants_sparse(alg, spec: JacobianSpec) -> bool:
    """True when ``alg`` will take the colored sparse-AD path, so the solve
    builds the host-side plan before its loop."""
    policy = getattr(alg, "jacobian", None)
    if policy is None:
        return False
    if policy.mode == "sparse":
        return True
    return policy.mode == "auto" and spec.sparsity is not None


def construct_jacobian(policy: JacobianPolicy, linsolve, ctx,
                       spec: Optional[JacobianSpec],
                       concrete_jac: Optional[bool] = None):
    """Returns ``(jac_fn, kind)`` with kind 'operator' or 'sparse';
    ``jac_fn(u)`` produces the J handed to the descent."""
    spec = spec or JacobianSpec()
    is_krylov = linsolve is not None and getattr(linsolve, "is_krylov", False)
    if policy.mode == "operator" or (
            is_krylov and policy.mode == "auto" and concrete_jac is not True):
        op = JacobianOperator(ctx.f_flat, spec.analytic_jvp)
        return (lambda u: op.at(u)), "operator"
    if policy.mode == "sparse" or (
            policy.mode == "auto" and spec.sparsity is not None):
        plan = spec.sparse_plan          # built once by solve()
        # Krylov consumers of a stencil-born (DIA-tier) pattern get J
        # assembled straight into the (ndiag, n) layout: one selection per
        # Jacobian, then K4 in every product.  The JAX package takes this
        # route on the TPU only (off it, behind a test hook); the port takes
        # it on either device, so the CPU runs the route the card runs.
        if (is_krylov and getattr(linsolve, "precond", None) != "device_lu"
                and plan.dia_plan is not None):
            return (lambda u: plan.dia(ctx.f_flat, u)), "sparse"
        return (lambda u: plan(ctx.f_flat, u)), "sparse"
    raise NotImplementedError(
        f"a concrete dense Jacobian (policy mode {policy.mode!r} with linear "
        f"solver {getattr(linsolve, 'method', None)!r}) is ROADMAP A.32; use "
        f"LinearSolver(method='gmres'), or mode='sparse' with a sparsity "
        f"pattern")

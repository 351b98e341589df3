"""Jacobian construction (the port of ``core/jacobian.py``): the policy
router between the matrix-free operator, the colored sparse-AD Jacobian and
a dense Jacobian (the problem's analytic ``jac``, or dense AD)."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from ..ops.operators import JacobianOperator
from .autodiff import JacobianPolicy, construct_dense_jacobian_fn


@dataclasses.dataclass(frozen=True)
class JacobianSpec:
    """Problem-level derivative info (from NonlinearFunction)."""

    analytic: Optional[Callable] = None       # u -> (n_out, n_in) dense
    analytic_jvp: Optional[Callable] = None   # (v, u) -> J@v
    analytic_vjp: Optional[Callable] = None   # (v, u) -> Jᵀ@v
    sparsity: Any = None                      # CSR pattern / COO / mask
    colorvec: Any = None
    sparse_plan: Any = None                   # host-built ColoredJacobian


def wants_sparse(alg, spec: JacobianSpec) -> bool:
    """True when ``alg`` (or a rung of a polyalgorithm) will take the
    colored sparse-AD path, so the solve builds the host-side plan before
    its loop.  Only the first-order engine takes it (the quasi-Newton
    engine's Jacobian is dense)."""
    from ..solvers.first_order import GeneralizedFirstOrderAlgorithm
    rungs = getattr(alg, "algs", None)
    if rungs is not None:
        return any(wants_sparse(a, spec) for a in rungs)
    if not isinstance(alg, GeneralizedFirstOrderAlgorithm):
        return False
    policy = alg.jacobian
    if policy.mode == "sparse":
        return True
    return policy.mode == "auto" and spec.sparsity is not None


def construct_jacobian(policy: JacobianPolicy, linsolve, ctx,
                       spec: Optional[JacobianSpec],
                       concrete_jac: Optional[bool] = None):
    """Returns ``(jac_fn, kind)`` with kind 'operator', 'sparse' or
    'dense'; ``jac_fn(u)`` produces the J handed to the descent (a dense
    J is ``(n_out, n_in)``, whatever the state's shape)."""
    spec = spec or JacobianSpec()
    is_krylov = linsolve is not None and getattr(linsolve, "is_krylov", False)
    if policy.mode == "operator" or (
            is_krylov and policy.mode == "auto" and concrete_jac is not True):
        op = JacobianOperator(ctx.f_flat, spec.analytic_jvp,
                              spec.analytic_vjp)
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

    jac_fn = construct_dense_jacobian_fn(ctx.f_flat, policy, ctx.n_in,
                                         ctx.n_out, spec.analytic)

    # the Jacobian of a shaped residual is out_shape + in_shape: the linear
    # algebra wants it 2-D, in C order
    def jac_2d(u):
        J = jac_fn(u)
        if J.dim() != 2:
            return J.reshape(ctx.n_out, ctx.n_in)
        return J

    return jac_2d, "dense"

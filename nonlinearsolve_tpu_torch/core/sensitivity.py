"""Implicit-function sensitivities (the port of ``core/sensitivity.py``).

A solve whose parameters ``p`` carry a gradient (``requires_grad`` under
grad mode, or a forward-mode tangent) returns its root through
``RootFunction``: the engine runs under ``torch.no_grad()`` and the root
u*(p) is differentiated by the implicit-function rule at the converged
point, never through the iterations.

- reverse mode (``backward``): p̄ = −(∂g/∂p)ᵀ J⁻ᵀ ū;
- forward mode (``jvp``, for ``torch.autograd.forward_ad``):
  u̇ = −J⁻¹ (∂g/∂p) ṗ;

with g = F for a square residual and, for least squares, the stationarity
system g = J_Fᵀ F, whose Jacobian is the exact Hessian of ½‖F‖² (second-
order terms included by a nested ``vjp``).  The backward rebuilds u(p)
through the same Function and computes with graph, so the rule is
differentiable again (second derivatives).  Tangents through ``u0`` and
the bounds are zero, as in the JAX package.

Forward-mode products go through ``core/autodiff.py``'s ``jvp`` and
``jacfwd`` (reverse mode inside a forward-AD level, which PyTorch does
not nest).  The linear solve with J = ∂g/∂u (``implicit_solve``) takes the JAX
package's branches: up to ``_DENSE_IFT_LIMIT`` unknowns (at every size for
a root made with ``dense=True``, the continuation methods') a dense
``torch.func.jacfwd`` and an LU solve; above it GMRES (restart
min(50, n), 500 iterations, rtol 1e-8) on g's ``torch.func.jvp``, its
transpose on g's ``torch.func.vjp``; for least squares MINRES (10·n
iterations, rtol 1e-8), the system being symmetric.  ``STATS`` keeps the
last solve's branch, iterations and relative residual.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.autograd import forward_ad
from torch.utils import _pytree

from .autodiff import jacfwd, jvp

_DENSE_IFT_LIMIT = 2048

# the last implicit solve: branch ("dense", "gmres", "minres"), Krylov
# iterations, ‖rhs − M x‖ / ‖rhs‖ (Krylov branches) and whether it met
# its tolerance
STATS: dict = {}


def _primal(t):
    """``t`` without its forward-mode tangent (``t`` itself otherwise)."""
    if isinstance(t, torch.Tensor) and forward_ad._current_level >= 0:
        return forward_ad.unpack_dual(t).primal
    return t


def _has_tangent(t) -> bool:
    return (isinstance(t, torch.Tensor) and forward_ad._current_level >= 0
            and forward_ad.unpack_dual(t).tangent is not None)


def strip_tangents(tree):
    """``tree`` (a tensor, tuple, list or dict of them) with every leaf
    detached from forward-mode tangents: what the engine runs on."""
    return _pytree.tree_map(_primal, tree)


def differentiable_leaves(p) -> list:
    """Indices, in ``_pytree.tree_flatten(p)`` order, of the leaves of
    ``p`` that carry a gradient: they require grad under grad mode, or they
    carry a forward-mode tangent."""
    leaves, _ = _pytree.tree_flatten(p)
    grad = torch.is_grad_enabled()
    return [i for i, t in enumerate(leaves)
            if isinstance(t, torch.Tensor) and t.is_floating_point()
            and ((grad and t.requires_grad) or _has_tangent(t))]


@dataclasses.dataclass(frozen=True, eq=False)
class ImplicitRoot:
    """What the rule needs besides the root: ``residual(u, p)`` in the
    iterate's space (bounds and preconditioning composed), ``p`` with its
    differentiable leaves at ``index`` (they are replaced by the Function's
    inputs), whether the residual is square, and whether the linear solve
    takes the dense branch at every size (``dense``: the continuation
    methods' rule)."""

    residual: Callable
    p: Any
    index: tuple
    square: bool
    dense: bool = False

    def p_of(self, leaves):
        flat, spec = _pytree.tree_flatten(self.p)
        flat = [_primal(t) for t in flat]
        for i, leaf in zip(self.index, leaves):
            flat[i] = leaf
        return _pytree.tree_unflatten(flat, spec)

    def g(self, u, leaves):
        """g(u, p): F for a square residual, else J_Fᵀ F."""
        p = self.p_of(leaves)
        if self.square:
            return self.residual(u, p)
        fu, vjp_fn = torch.func.vjp(lambda v: self.residual(v, p), u)
        return vjp_fn(fu)[0]


def _apply_op(root, u, leaves, x, transpose):
    """M·x for M = ∂g/∂u at (u, leaves), or Mᵀ·x."""
    def g(v):
        return root.g(v, leaves)
    if transpose and root.square:
        return torch.func.vjp(g, u)[1](x)[0]
    return jvp(g, u, x)[1]


def _krylov(root, u, leaves, rhs, transpose):
    from ..ops.krylov import gmres, minres
    n = u.numel()
    g = lambda v: root.g(v, leaves)                       # noqa: E731
    if not root.square:
        branch = "minres"

        def op(v):
            return jvp(g, u, v)[1]
        res = minres(op, rhs, maxiter=10 * n, rtol=1e-8)
    else:
        branch = "gmres"
        if transpose:
            vjp_fn = torch.func.vjp(g, u)[1]

            def op(v):
                return vjp_fn(v)[0]
        else:
            def op(v):
                return jvp(g, u, v)[1]
        res = gmres(op, rhs, restart=min(50, n), maxiter=500, rtol=1e-8)
    bnorm = float(torch.linalg.vector_norm(rhs))
    rel = float(torch.linalg.vector_norm(rhs - op(res.x))) / (bnorm or 1.0)
    STATS.clear()
    STATS.update(branch=branch, iterations=int(res.iterations),
                 rel_residual=rel, success=bool(res.success),
                 transpose=bool(transpose))
    return res.x


class _KrylovSolve(torch.autograd.Function):
    """x = M⁻¹ rhs on a Krylov branch, differentiable in rhs, u and the
    leaves: x̄ gives λ = M⁻ᵀ x̄, rhs̄ = λ and θ̄ = −(∂(M x)/∂θ)ᵀ λ for
    θ = (u, leaves), as the JAX package's ``custom_linear_solve``."""

    @staticmethod
    def forward(rhs, u, root, transpose, *leaves):
        return _krylov(root, u, leaves, rhs, transpose)

    @staticmethod
    def setup_context(ctx, inputs, output):
        rhs, u, root, transpose, *leaves = inputs
        ctx.save_for_backward(u, output, *leaves)
        ctx.root, ctx.transpose = root, transpose

    @staticmethod
    def backward(ctx, gx):
        u, x, *leaves = ctx.saved_tensors
        root, transpose = ctx.root, ctx.transpose
        lam = implicit_solve(root, u, leaves, gx, not transpose)
        xd = x.detach()
        _, vjp_fn = torch.func.vjp(
            lambda v, *ls: _apply_op(root, v, ls, xd, transpose), u, *leaves)
        grads = vjp_fn(-lam)
        return (lam, grads[0], None, None, *grads[1:])


def implicit_solve(root: ImplicitRoot, u, leaves, rhs, transpose: bool):
    """x with M x = rhs (``transpose``: Mᵀ x = rhs), M = ∂g/∂u at (u, p):
    the JAX package's branches (module docstring)."""
    n = u.numel()
    if n <= _DENSE_IFT_LIMIT or root.dense:
        J = jacfwd(lambda v: root.g(v, leaves))(u).reshape(n, n)
        STATS.clear()
        STATS.update(branch="dense", iterations=0, rel_residual=0.0,
                     success=True, transpose=bool(transpose))
        # jnp.linalg.solve: NaN for a singular M, no raise, no host read
        x, info = torch.linalg.solve_ex(J.mT if transpose else J,
                                        rhs.reshape(-1), check_errors=False)
        x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
        return x.reshape(u.shape)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (rhs, u, *leaves)):
        return _KrylovSolve.apply(rhs, u, root, transpose, *leaves)
    with torch.no_grad():
        return _krylov(root, u, leaves, rhs, transpose)


class RootFunction(torch.autograd.Function):
    """u*(p) at the solved root ``u_val`` (the iterate: the unbounded
    variable when the problem has bounds).  The forward returns the root;
    ``backward`` and ``jvp`` are the implicit-function rule."""

    @staticmethod
    def forward(u_val, root, *leaves):
        return u_val.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        u_val, root, *leaves = inputs
        ctx.root = root
        ctx.save_for_backward(u_val, *leaves)
        ctx.save_for_forward(u_val, *leaves)

    @staticmethod
    def backward(ctx, gu):
        u_val, *leaves = ctx.saved_tensors
        root = ctx.root
        # with graph (a second derivative asked for), u(p) is rebuilt
        # through this Function so that the rule's own terms see it
        u = (RootFunction.apply(u_val, root, *leaves)
             if torch.is_grad_enabled() else u_val)
        lam = implicit_solve(root, u, leaves, gu.reshape(u.shape), True)
        _, vjp_fn = torch.func.vjp(lambda *ls: root.g(u, ls), *leaves)
        return (None, None, *vjp_fn(-lam))

    @staticmethod
    def jvp(ctx, du_val, droot, *dleaves):
        u_val, *leaves = ctx.saved_tensors
        root = ctx.root
        tangents = tuple(torch.zeros_like(l) if d is None else d
                         for l, d in zip(leaves, dleaves))
        # ∂g/∂p·ṗ, the leaves flattened into one vector
        sizes = [l.numel() for l in leaves]

        def g_of(flat):
            parts = torch.split(flat, sizes)
            return root.g(u_val, [q.reshape(l.shape)
                                  for q, l in zip(parts, leaves)])
        _, b = jvp(g_of, torch.cat([l.reshape(-1) for l in leaves]),
                   torch.cat([t.reshape(-1) for t in tangents]))
        return -implicit_solve(root, u_val, leaves, b, False)


def differentiable_root(u_val, residual, p, index, square, dense=False):
    """``u_val`` joined to the graph of ``p``'s leaves at ``index`` by the
    implicit-function rule (``RootFunction``); ``dense`` forces the dense
    branch of the linear solve."""
    leaves, _ = _pytree.tree_flatten(p)
    root = ImplicitRoot(residual=residual, p=p, index=tuple(index),
                        square=square, dense=dense)
    return RootFunction.apply(u_val, root, *[leaves[i] for i in index])

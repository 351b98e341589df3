"""Jacobian policies and dense Jacobians (the port of ``core/autodiff.py``).

``JacobianPolicy`` picks the route; ``construct_dense_jacobian_fn`` builds
the dense ``(n_out, n_in)`` Jacobian of the residual with ``torch.func``:
forward mode (``jacfwd``, or ``vmap`` of ``jvp`` over chunks of the
identity), reverse mode (``jacrev``) or forward differences (``vmap`` over
the columns).  The residual may take a shaped state: its Jacobian comes
back as ``out_shape + in_shape`` and ``core/jacobian.py`` makes it 2-D.

``jvp`` and ``jacfwd`` are the forward-mode products every engine takes.
PyTorch does not nest forward-AD levels, so inside one (a caller
differentiating a solve with ``torch.autograd.forward_ad``) they take the
same products in reverse mode: J·v as the VJP of the VJP, the Jacobian by
``jacrev``.  J·v on a DTensor state takes the reverse route too, by
``torch.autograd``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch._functorch import eager_transforms as _eager
from torch.autograd import forward_ad


def forward_level_active() -> bool:
    """True inside a caller's ``torch.autograd.forward_ad`` dual level.
    ``torch.func.jvp`` enters one too, at its outermost call, but nests
    its own levels inside it: there (``JVP_NESTING`` > 0) forward mode
    stays available."""
    return forward_ad._current_level >= 0 and _eager.JVP_NESTING == 0


def jvp(f: Callable, u, v):
    """``(f(u), J(u)·v)``: ``torch.func.jvp``, or inside a forward-AD
    level the VJP of the (linear) VJP.  On a DTensor state (forward mode
    has no sharding rule for DTensors) the VJP of the VJP is taken with
    ``torch.autograd``, which keeps the residual's tensors DTensors
    (``torch.func`` would wrap them)."""
    from torch.distributed.tensor import DTensor
    if isinstance(u, DTensor):
        from .. import parallel  # noqa: F401  (its DTensor rules)
        return _dtensor_jvp(f, u, v)
    if not forward_level_active():
        return torch.func.jvp(f, (u,), (v,))
    fu, vjp_fn = torch.func.vjp(f, u)
    _, back = torch.func.vjp(lambda w: vjp_fn(w)[0], torch.zeros_like(fu))
    return fu, back(v)[0]


def _dtensor_jvp(f: Callable, u, v):
    """``(f(u), J(u)·v)`` as the VJP of the VJP by ``torch.autograd``.

    On one mesh axis it runs in the state's placements, and a residual
    shaped like the state comes back in them with its J·v; a residual
    that selects, unbinds, stacks, rolls or indexes components takes the
    DTensor rules that ``parallel/dtensor_rules.py`` registers (ROADMAP
    C.6, C.10).  On a mesh of two or more axes the VJP of the VJP runs on
    the state and the tangent replicated over the mesh, and both results
    go back to the state's placements (one all_gather of each a product;
    ROADMAP C.5)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = u.device_mesh
    if mesh.ndim > 1:
        rep = [Replicate()] * mesh.ndim
        fu, jv = _reverse_jvp(
            f, u.redistribute(mesh, rep),
            v.redistribute(mesh, rep) if isinstance(v, DTensor) else v)
        if fu.dim() != u.dim():
            return fu, jv
        return (fu.redistribute(mesh, u.placements),
                jv.redistribute(mesh, u.placements))
    fu, jv = _reverse_jvp(f, u, v)
    if (isinstance(fu, DTensor) and isinstance(jv, DTensor)
            and fu.shape == u.shape):
        # on one rank DTensor's costs tie, and torch 2.11 may leave the
        # residual and the J·v replicated there (no data moves)
        fu, jv = (x if x.placements == u.placements
                  else x.redistribute(mesh, u.placements) for x in (fu, jv))
    return fu, jv


def _reverse_jvp(f: Callable, u, v):
    with torch.enable_grad():
        x = u.detach().requires_grad_(True)
        fu = f(x)
        w = torch.zeros_like(fu, requires_grad=True)
        g, = torch.autograd.grad(fu, x, w, create_graph=True)
        jv, = torch.autograd.grad(g, w, v)
    return fu.detach(), jv


def jacfwd(f: Callable) -> Callable:
    """``torch.func.jacfwd(f)``, or ``jacrev`` inside a forward-AD
    level; for a complex state the holomorphic Jacobian (JAX's
    ``holomorphic=True``), which ``torch.func`` refuses."""
    def jac(u, *rest):
        if u.is_complex():
            g = (lambda v: f(v, *rest)) if rest else f
            return (_holomorphic_jacrev(g, u) if forward_level_active()
                    else _holomorphic_jacfwd(g, u))
        if forward_level_active():
            return torch.func.jacrev(f)(u, *rest)
        return torch.func.jacfwd(f)(u, *rest)
    return jac


def jacrev(f: Callable) -> Callable:
    """``torch.func.jacrev(f)``; the holomorphic Jacobian for a complex
    state."""
    def jac(u, *rest):
        if u.is_complex():
            return _holomorphic_jacrev(
                (lambda v: f(v, *rest)) if rest else f, u)
        return torch.func.jacrev(f)(u, *rest)
    return jac


def _holomorphic_jacfwd(f: Callable, u: torch.Tensor) -> torch.Tensor:
    """∂f/∂u of a holomorphic ``f``: the JVPs on the unit tangents, as
    ``out_shape + in_shape``."""
    n = u.numel()
    eye = torch.eye(n, dtype=u.dtype, device=u.device).reshape(
        (n,) + tuple(u.shape))
    cols = torch.func.vmap(lambda t: jvp(f, u, t)[1])(eye)
    out_shape = tuple(cols.shape[1:])
    return cols.reshape(n, -1).T.reshape(out_shape + tuple(u.shape))


def _holomorphic_jacrev(f: Callable, u: torch.Tensor) -> torch.Tensor:
    """The holomorphic ∂f/∂u by reverse mode: a VJP of ``torch.func``
    gives Jᴴ·g, so the rows on the unit cotangents are conjugated (JAX's
    VJP gives Jᵀ·g)."""
    fu, vjp_fn = torch.func.vjp(f, u)
    m = fu.numel()
    eye = torch.eye(m, dtype=fu.dtype, device=fu.device).reshape(
        (m,) + tuple(fu.shape))
    rows = torch.func.vmap(lambda g: vjp_fn(g)[0])(eye)
    return rows.conj_physical().reshape(tuple(fu.shape) + tuple(u.shape))


def pickchunksize(n: int, threshold: int = 12) -> int:
    """ForwardDiff.pickchunksize: the smallest chunk ≤ ``threshold`` that
    splits ``n`` into equal-ish batches."""
    if n <= threshold:
        return n
    nchunks = -(-n // threshold)
    return -(-n // nchunks)


@dataclasses.dataclass(frozen=True)
class JacobianPolicy:
    """mode: 'auto' | 'forward' | 'reverse' | 'finite' | 'analytic' |
    'operator' | 'sparse'.

    'auto' takes the matrix-free operator with a Krylov linear solver, the
    colored sparse-AD Jacobian when the problem has a sparsity pattern, and
    otherwise a dense AD Jacobian: forward mode, or reverse mode when the
    output is much smaller than the input (``resolve``).
    ``fd_rel_step``: the relative step of 'finite' (√eps by default).
    ``chunk_size``: forward-mode tangents ``chunk_size`` at a time — peak
    tangent memory chunk × n_out instead of n_in × n_out."""

    mode: str = "auto"
    fd_rel_step: Optional[float] = None
    chunk_size: Optional[int] = None

    def resolve(self, n_in: int, n_out: int) -> str:
        if self.mode != "auto":
            return self.mode
        # forward mode costs ~ n_in passes, reverse ~ n_out
        if n_out * 4 < n_in:
            return "reverse"
        return "forward"


def _chunked_jacfwd(f_flat: Callable, u: torch.Tensor, chunk: int,
                    n_out: int) -> torch.Tensor:
    """Forward-mode Jacobian of a flat ``u`` in tangent batches of
    ``chunk`` (the JAX package's ``lax.map`` over chunks)."""
    n = u.shape[0]
    nchunks = -(-n // chunk)

    def one_chunk(tangents):
        return torch.func.vmap(
            lambda t: jvp(f_flat, u, t)[1])(tangents)

    eye = torch.eye(n, dtype=u.dtype, device=u.device)
    cols = [one_chunk(eye[c * chunk:(c + 1) * chunk]).reshape(-1, n_out)
            for c in range(nchunks)]
    return torch.cat(cols, dim=0).T


def _finite_diff_jacobian(f_flat: Callable, u: torch.Tensor, rel_step):
    """Forward differences, vmapped over the columns of a flat ``u``."""
    fu = f_flat(u)
    eps = torch.finfo(u.real.dtype).eps
    h = (torch.sqrt(torch.tensor(eps, dtype=u.dtype, device=u.device))
         if rel_step is None else rel_step)
    step = h * torch.clamp(u.abs(), min=1.0)
    eye = torch.eye(u.shape[0], dtype=u.dtype, device=u.device)

    def col(e):
        du = e * step                    # step[i] at i, zeros elsewhere
        return (f_flat(u + du) - fu) / du.sum()

    return torch.func.vmap(col, out_dims=1)(eye)


def construct_dense_jacobian_fn(
    f_flat: Callable, policy: JacobianPolicy, n_in: int, n_out: int,
    analytic_jac_flat: Optional[Callable] = None,
) -> Callable:
    """``jac_fn(u) -> J``: the analytic Jacobian when given, otherwise AD
    by the resolved mode.  Chunked forward mode and finite differences
    take a flat ``u``."""
    if analytic_jac_flat is not None:
        return analytic_jac_flat
    mode = policy.resolve(n_in, n_out)
    if mode == "forward":
        if policy.chunk_size is not None:
            chunk = max(1, min(int(policy.chunk_size), n_in))
            return lambda u: _chunked_jacfwd(f_flat, u, chunk, n_out)
        return lambda u: jacfwd(f_flat)(u)
    if mode == "reverse":
        return lambda u: jacrev(f_flat)(u)
    if mode == "finite":
        return lambda u: _finite_diff_jacobian(f_flat, u, policy.fd_rel_step)
    raise ValueError(f"unknown jacobian mode {mode!r}")

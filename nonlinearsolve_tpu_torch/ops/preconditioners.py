"""Preconditioners (the port of ``ops/preconditioners.py``'s
``jacobi_preconditioner``, ``block_jacobi_preconditioner``,
``fft_poisson_symbol`` and ``fft_poisson_preconditioner``).  Each returns a
``v -> M⁻¹ v`` callable for ``LinearSolver(precond_fn=...)``.

``jacobi_preconditioner`` divides by a diagonal (zeros taken as 1);
``block_jacobi_preconditioner`` inverts the (n_blocks, b, b) diagonal blocks
in one batched ``torch.linalg.inv`` (the JAX package's ``jnp.linalg.inv``)
and applies them as one batched matvec.

The FFT preconditioner, on ``torch.fft``, inverts ``alpha·Δ_h - shift`` on a periodic grid.  For
two components it packs them as ``z = u + i·w`` and preconditions both in
one complex FFT round trip (the symbol is real); other cases take the rfft
route.  The reciprocal symbol is computed once per factory, per real dtype
and device, at first use.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .. import _backend


def jacobi_preconditioner(diag):
    """``v ↦ v / diag``, with a zero of ``diag`` taken as 1."""
    safe = torch.where(diag == 0, torch.ones_like(diag), diag)
    return lambda v: v / safe


def block_jacobi_preconditioner(blocks):
    """``blocks`` (n_blocks, b, b): the dense diagonal blocks, inverted once
    in a batch; ``v`` (n_blocks·b entries, any shape) is multiplied
    blockwise."""
    n_blocks, b, _ = blocks.shape
    inv = torch.linalg.inv(blocks)

    def apply(v):
        out = torch.bmm(inv, v.reshape(n_blocks, b, 1))
        return out.reshape(v.shape)

    return apply


def fft_poisson_symbol(shape: Sequence[int], alpha, h, shift=1.0,
                       dtype=torch.float64, device=None) -> torch.Tensor:
    """Eigenvalues of ``alpha·Δ_h - shift`` on a periodic grid:
    ``(α/h²)·Σ_d (2cos(2πk_d/N_d) - 2) - shift``, on ``device`` (the card by
    default)."""
    device = _backend.resolve_device(device)
    sym = None
    for d, Nd in enumerate(shape):
        k = torch.arange(Nd, dtype=dtype, device=device)
        lam = 2.0 * torch.cos(2.0 * math.pi * k / Nd) - 2.0
        expand = [1] * len(shape)
        expand[d] = Nd
        lam = lam.reshape(expand)
        sym = lam if sym is None else sym + lam
    return (alpha / (h * h)) * sym - shift


def fft_poisson_preconditioner(grid_shape: Sequence[int], alpha, h, *,
                               shift=1.0, n_components: int = 1,
                               component_axis: int = -1):
    """Return ``M(v)`` approximating ``(α Δ_h - shift·I)⁻¹ v`` for ``v`` laid
    out as the periodic grid plus an optional trailing component axis
    (flat or shaped)."""
    if component_axis != -1:
        raise NotImplementedError(
            "component_axis other than -1 is ROADMAP A.24")
    grid_shape = tuple(int(s) for s in grid_shape)
    last = grid_shape[-1]
    grid_axes = tuple(range(len(grid_shape)))
    inv_syms: dict = {}

    def inv_sym(real_dt, device, half: bool):
        key = (real_dt, device, half)
        if key not in inv_syms:
            sym = fft_poisson_symbol(grid_shape, alpha, h, shift, real_dt,
                                     device)
            inv_syms[key] = 1.0 / (sym[..., : last // 2 + 1] if half
                                   else sym)
        return inv_syms[key]

    def apply(v):
        dtype = v.dtype
        real_dt = torch.float64 if dtype == torch.float64 else torch.float32
        if n_components == 2 and not dtype.is_complex:
            # Two-for-one: z = u + i·w is a view of the interleaved (…, 2)
            # layout, and the output's (re, im) pairs are the (…, 2) layout
            # again — no copies beyond the FFTs themselves.
            w = v.reshape(grid_shape + (2,)).to(real_dt).contiguous()
            zh = torch.fft.fftn(torch.view_as_complex(w), dim=grid_axes)
            out = torch.fft.ifftn(zh * inv_sym(real_dt, v.device, False),
                                  dim=grid_axes)
            return torch.view_as_real(out).to(dtype).reshape(v.shape)
        if n_components > 1:
            w = v.reshape(grid_shape + (n_components,)).movedim(-1, 0)
        else:
            w = v.reshape(grid_shape)[None]
        axes = tuple(range(1, 1 + len(grid_shape)))
        what = torch.fft.rfftn(w, dim=axes)
        what = what * inv_sym(real_dt, v.device, True)[None]
        out = torch.fft.irfftn(what, s=grid_shape, dim=axes).to(dtype)
        if n_components > 1:
            out = out.movedim(0, -1)
        return out.reshape(v.shape)

    return apply

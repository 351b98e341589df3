"""Preconditioners (the port of ``ops/preconditioners.py``'s
``jacobi_preconditioner``, ``block_jacobi_preconditioner``,
``fft_poisson_symbol`` and ``fft_poisson_preconditioner``).  Each returns a
``v -> M⁻¹ v`` callable for ``LinearSolver(precond_fn=...)``.

Every factory here is tagged with ``utils/aot.py``'s ``carried_factory``:
what it returns carries the call that made it, so a solver holding it
crosses ``export_solver`` as that call.

``jacobi_preconditioner`` divides by a diagonal (zeros taken as 1);
``block_jacobi_preconditioner`` inverts the (n_blocks, b, b) diagonal blocks
in one batched ``torch.linalg.inv`` (the JAX package's ``jnp.linalg.inv``)
and applies them as one batched matvec.

The FFT preconditioner, on ``torch.fft``, inverts ``alpha·Δ_h - shift`` on a periodic grid.  For
two components it packs them as ``z = u + i·w`` and preconditions both in
one complex FFT round trip (the symbol is real); other cases take the rfft
route.  The reciprocal symbol is computed once per factory, per real dtype
and device, at first use.

``mxu_poisson_preconditioner`` is the same inverse with the DFT written as
dense matrix products (the JAX package's MXU variant), a ``prep(u) ->
apply`` factory that builds the DFT matrices once a linearization;
``hybrid_poisson_preconditioner`` is a ``prep(u, fu)`` factory
(``wants_residual``) that takes the matrix products while ‖fu‖∞ is above
``switch_abs`` and the exact FFT below it.  The products are plain
``torch.tensordot`` (the JAX package's ``jnp.tensordot``, outside any
Pallas kernel).  On the CPU they run in IEEE f32 whatever the precision
name, as the JAX package's do there; on the card the name picks torch's
f32 matmul precision for the products alone (``_matmul_precision``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import torch
from torch.distributed.tensor import DTensor

from .. import _backend
from ..utils.aot import carried_factory


@carried_factory
def jacobi_preconditioner(diag):
    """``v ↦ v / diag``, with a zero of ``diag`` taken as 1."""
    safe = torch.where(diag == 0, torch.ones_like(diag), diag)
    return lambda v: v / safe


@carried_factory
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


@carried_factory
def fft_poisson_preconditioner(grid_shape: Sequence[int], alpha, h, *,
                               shift=1.0, n_components: int = 1,
                               component_axis: int = -1):
    """Return ``M(v)`` approximating ``(α Δ_h - shift·I)⁻¹ v`` for ``v`` laid
    out as the periodic grid plus an optional trailing component axis
    (flat or shaped; a DTensor is gathered once an apply).
    ``component_axis`` is accepted and not read: the components are
    always the trailing axis, as in the JAX package."""
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
        if isinstance(v, DTensor):
            # torch 2.11's DTensor has no FFT rules
            return _backend.apply_whole(apply, v)
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


def _dft_matrices(n: int, dtype=torch.float32, device=None):
    """Real and imaginary parts of the n-point DFT matrix
    F[j,k] = e^{-2πi·jk/n}: the int32 outer product reduced mod n before
    the trigonometry (the reduced jk < n is exact in f32), then one cos /
    sin pass, on ``device`` (the card by default).  The int32 product is
    exact only for n ≤ 46340, so larger n raises."""
    if n > 46340:
        raise ValueError(
            f"_dft_matrices: n={n} overflows the int32 i*j product "
            "(max 46340); a dense DFT matrix at this size is impractical "
            "anyway — use the FFT preconditioner family")
    device = _backend.resolve_device(device)
    i = torch.arange(n, dtype=torch.int32, device=device)
    jk = torch.remainder(i[:, None] * i[None, :], n).to(torch.float32)
    ang = jk * (-2.0 * math.pi / n)
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


_PRECISIONS = {None: "medium", "default": "medium", "bf16": "medium",
               "high": "high", "highest": "highest", "f32": "highest"}


def _resolve_precision(precision):
    """The JAX package's precision names (None, 'default', 'bf16', 'high',
    'highest', 'f32', any case) as torch's f32 matmul precisions: bf16
    ('medium'), TF32 ('high') or IEEE f32 ('highest')."""
    key = precision.lower() if isinstance(precision, str) else precision
    if key not in _PRECISIONS:
        raise ValueError(
            f"precision={precision!r}: expected one of "
            "None/'default'/'bf16'/'high'/'highest'/'f32'")
    return _PRECISIONS[key]


@contextlib.contextmanager
def _matmul_precision(precision: str, device: torch.device):
    """torch's f32 matmul precision set to ``precision`` on the card for
    the block, and restored after it; on the CPU the products stay IEEE
    f32 and nothing is set."""
    if device.type != "cuda":
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(precision)
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _dft_apply(xr, xi, mats, axes, inverse=False, precision="highest"):
    """Complex N-D DFT of (xr + i·xi) by matrix products along ``axes``,
    one (C, S) matrix pair per axis; the inverse uses conj(F)/n per
    axis."""
    scale = 1.0

    def td(M, a, axis):
        return torch.tensordot(M, a, dims=([1], [axis]))

    with _matmul_precision(precision, xr.device):
        for (C, S), a in zip(mats, axes):
            Sa = -S if inverse else S
            yr = td(C, xr, a) - td(Sa, xi, a)
            yi = td(C, xi, a) + td(Sa, xr, a)
            xr = torch.movedim(yr, 0, a)
            xi = torch.movedim(yi, 0, a)
            if inverse:
                scale = scale / C.shape[0]
    return (xr * scale, xi * scale) if inverse else (xr, xi)


@carried_factory
def mxu_poisson_preconditioner(grid_shape: Sequence[int], alpha, h, *,
                               shift=1.0, n_components: int = 1,
                               precision="high"):
    """The matrix-product DFT variant of ``fft_poisson_preconditioner``:
    ``prep(u) -> (v -> M⁻¹v)``.  ``prep`` builds the DFT matrices and the
    f32 reciprocal symbol on ``u``'s device (the card when ``u`` is None),
    once a linearization, outside the Krylov loop; the apply computes in
    f32 and returns ``v``'s dtype.  ``precision`` names the products'
    precision (``_resolve_precision``).  Its error acts as a floor of the
    nonlinear residual, so the exact FFT stays the default elsewhere."""
    grid_shape = tuple(int(s) for s in grid_shape)
    prec = _resolve_precision(precision)

    def prep(_u=None):
        device = _backend.resolve_device(
            None if _u is None else _backend.whole(_u).device)
        mats = tuple(_dft_matrices(n, device=device) for n in grid_shape)
        inv_sym32 = 1.0 / fft_poisson_symbol(grid_shape, alpha, h, shift,
                                             torch.float32, device)
        return _make_mxu_apply(grid_shape, n_components, prec, mats,
                               inv_sym32)

    return prep


def _make_mxu_apply(grid_shape, n_components, prec, mats, inv_sym32):
    """The ``v -> M⁻¹v`` closure over built DFT matrices and symbol (shared
    by the mxu and hybrid factories)."""
    axes = tuple(range(len(grid_shape)))

    def apply(v):
        dtype = v.dtype
        if n_components == 2 and not dtype.is_complex:
            w = v.reshape(grid_shape + (2,))
            xr = w[..., 0].to(torch.float32)
            xi = w[..., 1].to(torch.float32)
            xr, xi = _dft_apply(xr, xi, mats, axes, precision=prec)
            xr, xi = xr * inv_sym32, xi * inv_sym32
            xr, xi = _dft_apply(xr, xi, mats, axes, inverse=True,
                                precision=prec)
            out = torch.stack([xr, xi], dim=-1).to(dtype)
            return out.reshape(v.shape)
        if n_components > 1:
            w = torch.movedim(v.reshape(grid_shape + (n_components,)), -1, 0)
        else:
            w = v.reshape(grid_shape)[None]
        w32 = w.to(torch.float32)
        caxes = tuple(a + 1 for a in axes)
        xr, xi = _dft_apply(w32, torch.zeros_like(w32), mats, caxes,
                            precision=prec)
        xr, xi = xr * inv_sym32[None], xi * inv_sym32[None]
        xr, _ = _dft_apply(xr, xi, mats, caxes, inverse=True, precision=prec)
        out = xr.to(dtype)
        if n_components > 1:
            out = torch.movedim(out, 0, -1)
        return out.reshape(v.shape)

    return apply


@carried_factory
def hybrid_poisson_preconditioner(grid_shape: Sequence[int], alpha, h, *,
                                  shift=1.0, n_components: int = 1,
                                  switch_abs, loose_precision=None):
    """Residual-gated spectral preconditioner: ``prep(u, fu) -> (v ->
    M⁻¹v)`` takes, per Newton linearization, the loose matrix-product DFT
    (``loose_precision``, bf16 by default) while ‖fu‖∞ (of the flattened
    residual) is above ``switch_abs``, and the exact FFT inverse below it.
    The gate is one host read a linearization; the DFT matrices are built
    only when it opens.  ``switch_abs`` must sit above the loose path's
    residual floor, or the solve stalls there.  ``prep.wants_residual`` is
    True: the Krylov descent calls it as ``prep(u, fu)``."""
    from ..utils.pytree import ravel_pytree

    grid_shape = tuple(int(s) for s in grid_shape)
    exact = fft_poisson_preconditioner(grid_shape, alpha, h, shift=shift,
                                       n_components=n_components)
    prec = _resolve_precision(loose_precision)

    def prep(_u, fu):
        fu_flat, _ = ravel_pytree(fu)
        # the ∞-norm: the loose path's error concentrates in few entries,
        # so an l2 gate can sit below the loose floor and never trip
        big, = _backend.fetch(torch.max(torch.abs(fu_flat)) > switch_abs)
        if not big:
            return exact
        device = _backend.whole(fu_flat).device
        mats = tuple(_dft_matrices(n, device=device) for n in grid_shape)
        inv_sym32 = 1.0 / fft_poisson_symbol(grid_shape, alpha, h, shift,
                                             torch.float32, device)
        return _make_mxu_apply(grid_shape, n_components, prec, mats,
                               inv_sym32)

    prep.wants_residual = True
    return prep

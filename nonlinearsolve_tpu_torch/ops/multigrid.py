"""Geometric multigrid preconditioner for structured-grid operators (the
port of ``ops/multigrid.py``).

A V-cycle on the (N, N[, N]) grid itself: weighted-Jacobi or Chebyshev
smoothing (elementwise), full-weighting restriction (a reshape-mean),
piecewise-constant prolongation (``repeat_interleave``) and Jacobi sweeps on
the coarsest level.  There is no sparse hierarchy and no indexing; the
operator is re-discretised on each level with the restricted coefficient
field, so variable coefficients and Dirichlet boundaries are handled where
the FFT preconditioner does not apply.

``multigrid_preconditioner`` targets ``A u = alpha·Δ_h u − c(x)·u`` with
'periodic' or 'dirichlet' boundaries.  The JAX module has no Pallas kernel:
this is plain torch on the input's device, in the JAX package's order of
operations, so f64 results equal its to rounding.  A DTensor input (a state
sharded on a mesh) is gathered once an application and the V-cycle runs
whole on every rank, each keeping its shard of the result.  The factory is
tagged with ``utils/aot.py``'s ``carried_factory``, so a solver holding
its product crosses ``export_solver`` as the call that made it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.distributed.tensor import DTensor

from .. import _backend
from ..utils.aot import carried_factory


def _lap(u, bc: str):
    """Dimension-agnostic 5/7-point Laplacian numerator (no 1/h²):
    periodic by ``torch.roll``, Dirichlet with zeros outside the domain."""
    nd = u.dim()
    out = -(2.0 * nd) * u
    for ax in range(nd):
        if bc == "periodic":
            out = out + torch.roll(u, 1, ax) + torch.roll(u, -1, ax)
        else:
            n = u.shape[ax]
            zero = torch.zeros_like(u.narrow(ax, 0, 1))
            lo = torch.cat([zero, u.narrow(ax, 0, n - 1)], ax)
            hi = torch.cat([u.narrow(ax, 1, n - 1), zero], ax)
            out = out + lo + hi
    return out


def _restrict(u):
    """Full-weighting restriction: 2x average pooling per axis."""
    nd = u.dim()
    shape = []
    for s in u.shape:
        shape += [s // 2, 2]
    return u.reshape(shape).mean(dim=tuple(range(1, 2 * nd, 2)))


def _prolong(u):
    """Piecewise-constant prolongation: repeat 2x per axis."""
    for ax in range(u.dim()):
        u = torch.repeat_interleave(u, 2, dim=ax)
    return u


@carried_factory
def multigrid_preconditioner(grid_shape: Sequence[int], alpha, h, *,
                             c=None, bc: str = "periodic",
                             levels: int = None, nu: int = 2,
                             cycles: int = 1, omega: float = 2.0 / 3.0,
                             smoother: str = "jacobi"):
    """Return ``M(v) ≈ A⁻¹ v`` for ``A = alpha·Δ_h − diag(c)``.

    ``c``: reaction/shift field on the grid (a number or a tensor; default
    1).  ``bc``: 'periodic' | 'dirichlet'.  ``levels``: V-cycle depth
    (default: down to a ≤4-point axis).  ``nu``: pre+post smoothing
    sweeps.  ``smoother``: 'jacobi' (weighted, ω) or 'chebyshev'
    (degree-``nu`` polynomial on the D⁻¹A high-frequency interval
    [λmax/4, λmax], λmax = 1.95).  ``v`` may be flat or shaped; ``M(v)``
    has its shape, dtype and device."""
    grid_shape = tuple(int(s) for s in grid_shape)
    if levels is None:
        levels = max(1, min(s.bit_length() - 3 for s in grid_shape) + 1)

    def build_levels(c0):
        cs, hs = [c0], [h]
        for _ in range(levels - 1):
            cs.append(_restrict(cs[-1]))
            hs.append(hs[-1] * 2.0)
        return cs, hs

    def apply_A(u, c_l, h_l):
        return (alpha / (h_l * h_l)) * _lap(u, bc) - c_l * u

    def diag_A(c_l, h_l):
        return -(2.0 * len(grid_shape)) * alpha / (h_l * h_l) - c_l

    def smooth(u, f, c_l, h_l, sweeps):
        d = diag_A(c_l, h_l)
        if smoother == "chebyshev" and sweeps >= 2:
            # Chebyshev semi-iteration on D⁻¹A, whose eigenvalues lie in
            # (0, 2) by Gershgorin: smooth the band [lmax/4, lmax]
            lmax, lmin = 1.95, 1.95 / 4.0
            theta = (lmax + lmin) / 2.0
            delta = (lmax - lmin) / 2.0
            sigma = theta / delta
            rho = 1.0 / sigma
            r = (f - apply_A(u, c_l, h_l)) / d
            du = r / theta
            u = u + du
            for _ in range(sweeps - 1):
                rho_new = 1.0 / (2.0 * sigma - rho)
                r = (f - apply_A(u, c_l, h_l)) / d
                du = rho_new * rho * du + (2.0 * rho_new / delta) * r
                u = u + du
                rho = rho_new
            return u
        for _ in range(sweeps):
            r = f - apply_A(u, c_l, h_l)
            u = u + omega * r / d
        return u

    def vcycle(f, lvl, cs, hs):
        u = smooth(torch.zeros_like(f), f, cs[lvl], hs[lvl], nu)
        if lvl == levels - 1:
            return smooth(u, f, cs[lvl], hs[lvl], 2 * nu)
        r = f - apply_A(u, cs[lvl], hs[lvl])
        e = vcycle(_restrict(r), lvl + 1, cs, hs)
        u = u + _prolong(e)
        return smooth(u, f, cs[lvl], hs[lvl], nu)

    def apply(v):
        if isinstance(v, DTensor):
            return _backend.apply_whole(apply, v)
        dtype = v.dtype
        cc = c.full_tensor() if isinstance(c, DTensor) else c
        c0 = torch.as_tensor(1.0 if cc is None else cc, dtype=dtype,
                             device=v.device).expand(grid_shape)
        cs, hs = build_levels(c0)
        f = v.reshape(grid_shape)
        u = torch.zeros_like(f)
        for _ in range(cycles):
            u = u + vcycle(f - apply_A(u, cs[0], hs[0]), 0, cs, hs)
        return u.reshape(v.shape).to(dtype)

    return apply

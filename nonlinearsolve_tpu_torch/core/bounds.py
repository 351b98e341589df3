"""Bounds by a logit / log change of variable (the port of
``core/bounds.py``).

``lb ≤ u ≤ ub`` is enforced by solving in an unconstrained variable t with
u = lb + (ub − lb)·logistic(t) (two-sided), lb + eᵗ or ub − eᵗ (one-sided);
u0 is nudged into the strict interior by eps^(3/4)-scaled margins before
the forward transform.  Elementwise on the iterate's shape, branch-free by
``torch.where`` on the bounds' finiteness.
"""

from __future__ import annotations

import torch


def _logit(x):
    return torch.log(x) - torch.log1p(-x)


def to_unbounded(u, lb, ub):
    has_lb = torch.isfinite(lb)
    has_ub = torch.isfinite(ub)
    width = torch.where(has_lb & has_ub, ub - lb, torch.ones_like(ub))
    both = _logit(torch.clamp((u - lb) / width, 1e-300, 1.0))
    tiny = torch.finfo(u.dtype).tiny
    lo = torch.log(torch.clamp(u - lb, min=tiny))
    hi = torch.log(torch.clamp(ub - u, min=tiny))
    return torch.where(has_lb & has_ub, both,
                       torch.where(has_lb, lo, torch.where(has_ub, hi, u)))


def from_unbounded(t, lb, ub):
    has_lb = torch.isfinite(lb)
    has_ub = torch.isfinite(ub)
    both = lb + (ub - lb) * torch.sigmoid(t)
    lo = lb + torch.exp(t)
    hi = ub - torch.exp(t)
    return torch.where(has_lb & has_ub, both,
                       torch.where(has_lb, lo, torch.where(has_ub, hi, t)))


def clamp_to_bounds(u, lb, ub):
    """The interior clamp with eps^(3/4) margins."""
    has_lb = torch.isfinite(lb)
    has_ub = torch.isfinite(ub)
    eps_frac = torch.finfo(u.dtype).eps ** 0.75
    margin = (ub - lb) * eps_frac
    both = torch.minimum(torch.maximum(u, lb + margin), ub - margin)
    one = torch.ones_like(u)
    lo = torch.maximum(u, lb + eps_frac * torch.maximum(torch.abs(lb), one))
    hi = torch.minimum(u, ub - eps_frac * torch.maximum(torch.abs(ub), one))
    return torch.where(has_lb & has_ub, both,
                       torch.where(has_lb, lo, torch.where(has_ub, hi, u)))


def normalize_bounds(lb, ub, u0):
    """None → ∓inf, scalars broadcast; a tensor or sequence is taken in
    ``u0``'s element order.  Both come back in ``u0``'s shape, dtype and
    device."""
    n = u0.numel()

    def norm(b, fill):
        if b is None:
            return torch.full(u0.shape, fill, dtype=u0.dtype,
                              device=u0.device)
        b = torch.as_tensor(b, dtype=u0.dtype, device=u0.device)
        b = b.reshape(-1) if b.dim() else b
        return torch.broadcast_to(b, (n,)).reshape(u0.shape).clone()

    return norm(lb, -float("inf")), norm(ub, float("inf"))

"""Norms and tolerance defaults (the port of ``utils/norms.py``).

States are single tensors of any shape; norms reduce over every element
without flattening the caller's layout.  Norms and dots of complex states
are real, as the JAX package's.  Each norm is one reduction kernel
and returns a 0-d tensor on the input's device (no host sync).
"""

from __future__ import annotations

import numpy as np
import torch


def tree_size(x: torch.Tensor) -> int:
    return int(x.numel())


def tree_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ aᵢbᵢ over every element (real inner product), a 0-d tensor; for
    complex states Re Σ conj(aᵢ)bᵢ, as the JAX package's ``vdot(...).real``."""
    if a.is_complex():
        return torch.sum(a.conj() * b).real
    return torch.sum(a * b)


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """‖x‖₂, a real 0-d tensor (complex: √Σ Re(xᵢ conj(xᵢ)), as the JAX
    package's)."""
    if x.is_complex():
        return torch.sqrt(torch.sum((x * x.conj()).real))
    return torch.linalg.vector_norm(x)


def linf_norm(x: torch.Tensor) -> torch.Tensor:
    # propagates NaN, as jnp.max(jnp.abs(x)) does
    return torch.linalg.vector_norm(x, ord=float("inf"))


_NORMS = {"l2": l2_norm, "linf": linf_norm}


def get_norm(name: str):
    return _NORMS[name]


def apply_norm(name: str, x: torch.Tensor, y: torch.Tensor = None):
    """``apply_norm(f, x) = f(x)``; ``apply_norm(f, x, y) = f(x + y)``."""
    f = get_norm(name)
    return f(x) if y is None else f(x + y)


def default_tolerance(dtype) -> float:
    """``eps(T)^(4/5)``, with the Float64 literal 3.0e-13 special case
    (NonlinearSolve.jl common_defaults.jl:40-48)."""
    if isinstance(dtype, torch.dtype):
        dtype = torch.empty((), dtype=dtype).numpy().dtype
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        return 3.0e-13
    return float(float(np.finfo(dtype).eps) ** 0.8)


def get_tolerance(tol, dtype) -> float:
    if tol is None:
        return default_tolerance(dtype)
    return float(tol)

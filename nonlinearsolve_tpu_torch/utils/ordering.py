"""JAX's order on complex values, for the engines that compare or take
extremes of them (the trust regions, LM damping, Anderson's history mask,
the simple trust region and DFSane).

JAX (XLA) orders complex numbers lexicographically: real part first, then
imaginary part — ``jnp.max([1+5j, 2-1j, 2+3j])`` is ``2+3j`` and
``jnp.array(1+2j) > 1+1j`` is True — where torch refuses ``>``,
``torch.maximum`` and ``max`` on complex tensors.  Each helper takes
tensors (a Python number for ``b``); on real operands it is the plain
torch op.  numpy's host scalars already order complex values this way.
"""

from __future__ import annotations

import torch


def _complex(*xs) -> bool:
    return any(x.is_complex() if isinstance(x, torch.Tensor)
               else isinstance(x, complex) for x in xs)


def _parts(x):
    if isinstance(x, torch.Tensor):
        return (x.real, x.imag) if x.is_complex() else (x, 0.0)
    return complex(x).real, complex(x).imag


def greater(a, b, or_equal: bool = False):
    """``a > b`` (``a >= b`` with ``or_equal``), lexicographic on complex
    operands."""
    if not _complex(a, b):
        return a >= b if or_equal else a > b
    (ar, ai), (br, bi) = _parts(a), _parts(b)
    tie = torch.as_tensor(ai >= bi if or_equal else ai > bi)
    return torch.where(torch.as_tensor(ar == br), tie,
                       torch.as_tensor(ar > br))


def less(a, b, or_equal: bool = False):
    """``a < b`` (``a <= b`` with ``or_equal``), lexicographic on complex
    operands."""
    if not _complex(a, b):
        return a <= b if or_equal else a < b
    (ar, ai), (br, bi) = _parts(a), _parts(b)
    tie = torch.as_tensor(ai <= bi if or_equal else ai < bi)
    return torch.where(torch.as_tensor(ar == br), tie,
                       torch.as_tensor(ar < br))


def maximum(a: torch.Tensor, b) -> torch.Tensor:
    """Elementwise max (``jnp.maximum``), lexicographic on complex
    operands; the result has the promoted dtype."""
    if not _complex(a, b):
        return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype,
                                                device=a.device))
    dt = torch.result_type(a, b)
    a, b = a.to(dt), torch.as_tensor(b, dtype=dt, device=a.device)
    return torch.where(greater(a, b), a, b)


def minimum(a: torch.Tensor, b) -> torch.Tensor:
    """Elementwise min (``jnp.minimum``), lexicographic on complex
    operands."""
    if not _complex(a, b):
        return torch.minimum(a, torch.as_tensor(b, dtype=a.dtype,
                                                device=a.device))
    dt = torch.result_type(a, b)
    a, b = a.to(dt), torch.as_tensor(b, dtype=dt, device=a.device)
    return torch.where(less(a, b), a, b)


def amax(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The largest element (``jnp.max``) over ``dim`` (all when None):
    on complex values the largest real part, then among those the largest
    imaginary part."""
    return _extreme(x, dim, torch.amax, float("-inf"))


def amin(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The smallest element (``jnp.min``), lexicographic on complex."""
    return _extreme(x, dim, torch.amin, float("inf"))


def _extreme(x, dim, red, fill):
    kw = {} if dim is None else {"dim": dim}
    if not x.is_complex():
        return red(x, **kw)
    re = red(x.real, **kw)
    at = x.real == (re if dim is None else re.unsqueeze(dim))
    im = red(torch.where(at, x.imag, torch.full_like(x.imag, fill)), **kw)
    return torch.complex(re, im)

"""Nonlinear pre- and postconditioning (the port of
``core/conditioning.py``).

``precondition`` is a left residual transform ``G(fu, u, p)`` composed
before anything else sees the residual (the Jacobian, the termination
check and the reported ``resid`` all see the composed map);
``postcondition`` is an iterate corrector ``H(u_proposed, u_prev, p)``
applied at every commit point.  ``PostconditionSpecifier`` says which
coordinates H is written in when the problem also has bounds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


class PostconditionSpace:
    """Coordinate space the corrector is written in."""

    Original = "original"
    Transformed = "transformed"


@dataclasses.dataclass(frozen=True)
class PostconditionSpecifier:
    corrector: Callable
    space: str = "original"     # 'original' | 'transformed'

    def __post_init__(self):
        if self.space not in ("original", "transformed"):
            raise ValueError("space must be 'original' or 'transformed'")

    def __call__(self, u_prop, u_prev, p):
        return self.corrector(u_prop, u_prev, p)

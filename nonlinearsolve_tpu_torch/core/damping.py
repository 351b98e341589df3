"""Damping functions for ``DampedNewtonDescent`` (the port of
``core/damping.py``):

* ``LevenbergMarquardtDamping`` — Transtrum–Sethna diagonal damping λ·DᵀD
  with the running element-wise max of diag(JᵀJ);
* ``SwitchedEvolutionRelaxation`` — the SER pseudo-timestep of
  PseudoTransient, α⁻¹ₙ₊₁ = α⁻¹ₙ·‖fuₙ‖/‖fuₙ₋₁‖, with an optional mass
  matrix.

The states are device tensors (0-d for the scalars) and every update runs
on the device: a damped step reads nothing to build its system.  Only the
λ update after a step takes a host decision (accepted or not), as a
constant factor.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..utils import ordering
from ..utils.norms import l2_norm


@dataclasses.dataclass(frozen=True)
class LevenbergMarquardtDamping:
    increase_factor: float = 2.0
    decrease_factor: float = 3.0
    min_damping: float = 1e-8

    requires_normal_form_jacobian = False
    requires_normal_form_rhs = False
    returns_norm_form_damping = True


@dataclasses.dataclass(frozen=True)
class LMDampingState:
    lam: Any        # current λ, 0-d
    DtD: Any        # running max of diag(JᵀJ), a vector

    def replace(self, **kw) -> "LMDampingState":
        return dataclasses.replace(self, **kw)


def lm_damping_init(cfg: LevenbergMarquardtDamping, initial_damping, n: int,
                    dtype, device) -> LMDampingState:
    return LMDampingState(
        lam=torch.tensor(initial_damping, dtype=dtype, device=device),
        DtD=torch.full((n,), cfg.min_damping, dtype=dtype, device=device))


def lm_damping_update(cfg: LevenbergMarquardtDamping, state: LMDampingState,
                      jac_damp, *, is_normal_form: bool):
    """DᵀD ← max(DᵀD, diag(JᵀJ)) (JAX's order on a complex state); the
    damping is λ·DᵀD (a vector)."""
    if is_normal_form:
        j_diag = jac_damp.diagonal()
    else:
        j_diag = torch.sum(jac_damp * jac_damp, dim=0)   # diag(JᵀJ) from J
    DtD = ordering.maximum(state.DtD, j_diag)
    return state.lam * DtD, state.replace(DtD=DtD)


def lm_damping_post_step(cfg: LevenbergMarquardtDamping, state: LMDampingState,
                         accepted: bool):
    """λ ← λ/decrease if the step was accepted, λ·increase otherwise."""
    factor = 1.0 / cfg.decrease_factor if accepted else cfg.increase_factor
    return state.replace(lam=state.lam * factor)


@dataclasses.dataclass(frozen=True, eq=False)
class SwitchedEvolutionRelaxation:
    """SER damping: the damping α⁻¹ is added to diag(J).  ``mass_matrix``
    generalizes the step to ``(J + α⁻¹ M) δu = -F``: a dense (n, n) matrix
    or a diagonal vector (a tensor); None is the identity.  Compared by the
    mass matrix's identity."""

    mass_matrix: Any = None

    requires_normal_form_jacobian = False
    requires_normal_form_rhs = False
    returns_norm_form_damping = False


@dataclasses.dataclass(frozen=True)
class SERDampingState:
    alpha_inv: Any  # α⁻¹, 0-d
    res_norm: Any   # ‖fu‖ at the previous damping computation, 0-d


def ser_damping_init(cfg: SwitchedEvolutionRelaxation, initial_damping, fu,
                     dtype) -> SERDampingState:
    return SERDampingState(
        alpha_inv=torch.tensor(1.0 / initial_damping, dtype=dtype,
                               device=fu.device),
        res_norm=l2_norm(fu).to(dtype))


def ser_damping_update(cfg: SwitchedEvolutionRelaxation,
                       state: SERDampingState, fu):
    """α⁻¹ ← α⁻¹ · ‖fuₙ‖/‖fuₙ₋₁‖ (kept when that is not finite); the
    damping term is α⁻¹."""
    res_norm = l2_norm(fu)
    old = state.res_norm
    new_alpha_inv = state.alpha_inv * res_norm / torch.where(
        old == 0, torch.ones_like(old), old)
    new_alpha_inv = torch.where(torch.isfinite(new_alpha_inv), new_alpha_inv,
                                state.alpha_inv)
    return new_alpha_inv, SERDampingState(alpha_inv=new_alpha_inv,
                                          res_norm=res_norm)

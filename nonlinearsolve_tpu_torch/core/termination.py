"""Termination conditions (the port of ``core/termination.py``): the nine
modes — ``rel``, ``abs``, ``norm``, ``rel_norm``, ``abs_norm`` and the
``safe`` / ``safe_best`` variants of the last two — with their
constructors, the safe modes' stall and divergence protection and the
best-iterate retention.

A check needs a few scalars of device tensors: the norms of ``fu`` and of
``fu + u``, ‖u - u_prev‖ for the stall test, or (``rel``, ``abs``) the
element-wise verdict.  ``termination_norms`` gives them as 0-d device
tensors, so the engine reads them in the same host sync as its own
scalars; the rest of the logic runs on the host in the working dtype.  The
retained best iterate is a reference to a device tensor, never a copy.

The batched checks (``init_termination_batched``,
``check_termination_batched``; the simple tier and ensembles) keep one row
a trajectory on the device and read nothing.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from .._backend import fetch, real_np_dtype
from ..utils.norms import apply_norm, l2_norm
from .returncode import ReturnCode

SAFE_MODES = ("rel_norm_safe", "abs_norm_safe", "rel_norm_safe_best",
              "abs_norm_safe_best")
BEST_MODES = ("rel_norm_safe_best", "abs_norm_safe_best")
REL_NORM_MODES = ("rel_norm", "rel_norm_safe", "rel_norm_safe_best")
ABS_NORM_MODES = ("abs_norm", "abs_norm_safe", "abs_norm_safe_best")
ALL_MODES = ("rel", "abs", "norm") + REL_NORM_MODES + ABS_NORM_MODES


@dataclasses.dataclass(frozen=True)
class TerminationCondition:
    """Static termination config (defaults as the JAX package's).  ``norm``
    is 'linf' or 'l2'."""

    mode: str = "abs_norm_safe_best"
    norm: str = "linf"
    protective_threshold: Optional[float] = None
    patience_steps: int = 100
    patience_objective_multiplier: float = 3.0
    min_max_factor: float = 1.3
    max_stalled_steps: Optional[int] = None

    def __post_init__(self):
        if self.mode not in ALL_MODES:
            raise ValueError(f"unknown termination mode {self.mode!r}")

    @property
    def is_safe(self) -> bool:
        return self.mode in SAFE_MODES

    @property
    def keeps_best(self) -> bool:
        return self.mode in BEST_MODES

    @property
    def is_relative(self) -> bool:
        return self.mode in REL_NORM_MODES

    @property
    def checks_stall(self) -> bool:
        return self.is_safe and self.max_stalled_steps is not None


# Constructors named after the reference's public mode types.
def RelTerminationMode(**kw):
    return TerminationCondition(mode="rel", **kw)


def AbsTerminationMode(**kw):
    return TerminationCondition(mode="abs", **kw)


def NormTerminationMode(norm="l2", **kw):
    return TerminationCondition(mode="norm", norm=norm, **kw)


def RelNormTerminationMode(norm="l2", **kw):
    return TerminationCondition(mode="rel_norm", norm=norm, **kw)


def AbsNormTerminationMode(norm="l2", **kw):
    return TerminationCondition(mode="abs_norm", norm=norm, **kw)


def RelNormSafeTerminationMode(norm="l2", **kw):
    return TerminationCondition(mode="rel_norm_safe", norm=norm, **kw)


def AbsNormSafeTerminationMode(norm="l2", **kw):
    return TerminationCondition(mode="abs_norm_safe", norm=norm, **kw)


def RelNormSafeBestTerminationMode(norm="l2", **kw):
    return TerminationCondition(mode="rel_norm_safe_best", norm=norm, **kw)


def AbsNormSafeBestTerminationMode(norm="l2", **kw):
    return TerminationCondition(mode="abs_norm_safe_best", norm=norm, **kw)


def default_termination_mode(is_least_squares: bool, callee: str = "regular"):
    """simple → AbsNorm; regular → AbsNormSafeBest(max_stalled_steps=32);
    Linf for rootfinding, L2 for least squares."""
    norm = "l2" if is_least_squares else "linf"
    if callee == "simple":
        return AbsNormTerminationMode(norm=norm)
    return AbsNormSafeBestTerminationMode(norm=norm, max_stalled_steps=32)


@dataclasses.dataclass(frozen=True)
class TermState:
    """Runtime termination state: host scalars, plus the best iterate."""

    retcode: int
    nsteps: int
    best_objective: Any
    initial_objective: Any
    best_u: Any
    objectives_trace: Any
    u0_norm: Any
    step_norm_trace: Any

    def replace(self, **kw) -> "TermState":
        return dataclasses.replace(self, **kw)


def termination_norms(cfg: TerminationCondition, fu, u, uprev=None, *,
                      abstol=None, reltol=None) -> list:
    """The device scalars one check reads, in order: the element-wise
    verdict ('rel', 'abs'; the tolerances are needed for it), or ‖fu‖ and,
    for the relative modes and 'norm', ‖fu + u‖; then ‖u - uprev‖ when the
    stall test is on and ``uprev`` is given."""
    if cfg.mode == "rel":
        return [(fu.abs() <= float(reltol) * (u + fu).abs()).all()]
    if cfg.mode == "abs":
        return [(fu.abs() <= float(abstol)).all()]
    out = [apply_norm(cfg.norm, fu)]
    if cfg.mode == "norm" or cfg.is_relative:
        out.append(apply_norm(cfg.norm, fu, u))
    if uprev is not None and cfg.checks_stall:
        out.append(l2_norm(u - uprev))
    return out


def init_norms(cfg: TerminationCondition, fu, u) -> list:
    """The device scalars ``init_termination`` reads: the objective's
    norms (safe modes) and ‖u0‖ (relative safe modes with the stall
    test)."""
    if not cfg.is_safe:
        return []
    out = termination_norms(cfg, fu, u)
    if cfg.is_relative and cfg.max_stalled_steps is not None:
        out.append(l2_norm(u))
    return out


def _objective(cfg: TerminationCondition, norms, reltol):
    """‖fu‖, or for the relative modes ‖fu‖ / (‖fu + u‖ + eps(reltol)) —
    the guard is the ulp at reltol, eps(T)·reltol."""
    if cfg.is_relative:
        npdt = type(norms[0])
        return norms[0] / (norms[1] + npdt(np.finfo(npdt).eps) * reltol)
    return norms[0]


def init_termination(cfg: TerminationCondition, fu, u, reltol, *,
                     norms=None) -> TermState:
    """``norms``: host values of ``init_norms(cfg, fu, u)`` when the caller
    has already read them; otherwise they are read here."""
    npdt = real_np_dtype(u.dtype)
    reltol = npdt(reltol)
    u0_norm = objectives_trace = step_norm_trace = initial = None
    if cfg.is_safe:
        if norms is None:
            norms = fetch(*init_norms(cfg, fu, u))
        initial = _objective(cfg, norms, reltol)
        best = initial
        objectives_trace = np.zeros(cfg.patience_steps, npdt)
        if cfg.max_stalled_steps is not None:
            step_norm_trace = np.zeros(cfg.max_stalled_steps, npdt)
            if cfg.is_relative:
                u0_norm = norms[-1]
    else:
        best = npdt(np.inf)
    return TermState(retcode=int(ReturnCode.Default), nsteps=0,
                     best_objective=best, initial_objective=initial,
                     best_u=u if cfg.keeps_best else None,
                     objectives_trace=objectives_trace, u0_norm=u0_norm,
                     step_norm_trace=step_norm_trace)


def _plain_converged(cfg: TerminationCondition, norms, abstol,
                     reltol) -> bool:
    if cfg.mode in ("rel", "abs"):
        return bool(norms[0])
    if cfg.mode == "norm":
        return bool(norms[0] <= abstol or norms[0] <= reltol * norms[1])
    if cfg.mode == "rel_norm":
        return bool(norms[0] <= reltol * norms[1])
    return bool(norms[0] <= abstol)


def check_termination(cfg: TerminationCondition, state: TermState, fu, u,
                      uprev, abstol, reltol, *, norms=None,
                      is_least_squares: bool = False):
    """One termination check; returns ``(stop, new_state)``.

    Safe-mode logic in the reference's order: non-finite → Unstable;
    protective threshold → Unstable; best retention; main criterion →
    Success; patience → Stalled; step-norm stall → Stalled (StalledSuccess
    for least squares).  ``abstol`` and ``reltol`` are host scalars of the
    working dtype; ``norms`` the host values of ``termination_norms(cfg,
    fu, u, uprev, ...)``, read here when not given."""
    if norms is None:
        norms = fetch(*termination_norms(cfg, fu, u, uprev, abstol=abstol,
                                         reltol=reltol))
    if not cfg.is_safe:
        converged = _plain_converged(cfg, norms, abstol, reltol)
        retcode = int(ReturnCode.Success) if converged else state.retcode
        return converged, state.replace(retcode=retcode)

    npdt = type(state.best_objective)
    abstol, reltol = npdt(abstol), npdt(reltol)
    objective = _objective(cfg, norms, reltol)
    criteria = reltol if cfg.is_relative else abstol
    stop = False
    retcode = int(ReturnCode.Failure)

    if not np.isfinite(objective):
        stop, retcode = True, int(ReturnCode.Unstable)

    if cfg.protective_threshold is not None and not stop:
        if objective > (state.initial_objective
                        * npdt(cfg.protective_threshold) * npdt(fu.numel())):
            stop, retcode = True, int(ReturnCode.Unstable)

    best_objective, best_u = state.best_objective, state.best_u
    if cfg.keeps_best and objective < state.best_objective and not stop:
        best_objective, best_u = objective, u

    if objective <= criteria and not stop:
        stop, retcode = True, int(ReturnCode.Success)

    # patience: the objectives ring, counted on non-stopping checks only
    live = not stop
    nsteps = state.nsteps + (1 if live else 0)
    initial = (objective if live and nsteps == 1
               else state.initial_objective)
    objectives_trace = state.objectives_trace
    if live:
        objectives_trace = objectives_trace.copy()
        objectives_trace[(nsteps - 1) % cfg.patience_steps] = objective
    stalled_code = int(ReturnCode.StalledSuccess if is_least_squares
                       else ReturnCode.Stalled)
    patience_hit = False
    if (live and objective <= npdt(cfg.patience_objective_multiplier)
            * criteria and nsteps > cfg.patience_steps):
        filled = objectives_trace[:min(nsteps, cfg.patience_steps)]
        patience_hit = bool(filled.min() < npdt(cfg.min_max_factor)
                            * filled.max())
    if patience_hit:
        stop, retcode = True, stalled_code

    step_norm_trace = state.step_norm_trace
    if step_norm_trace is not None:
        if live:
            step_norm_trace = step_norm_trace.copy()
            step_norm_trace[(nsteps - 1) % cfg.max_stalled_steps] = norms[-1]
        max_step = step_norm_trace.max()
        if cfg.is_relative:
            stalled_step = max_step <= reltol * (max_step + state.u0_norm)
        else:
            stalled_step = max_step <= abstol
        if (live and not patience_hit and nsteps > cfg.max_stalled_steps
                and stalled_step):
            stop, retcode = True, stalled_code

    return stop, TermState(
        retcode=retcode, nsteps=nsteps, best_objective=best_objective,
        initial_objective=initial, best_u=best_u,
        objectives_trace=objectives_trace, u0_norm=state.u0_norm,
        step_norm_trace=step_norm_trace)


def termination_result(cfg: TerminationCondition, state: TermState,
                       fallback_u):
    """Safe-best modes return the retained best iterate."""
    if cfg.keeps_best and state.best_u is not None:
        return state.best_u
    return fallback_u


# ---------------------------------------------------------------------------
# batched checks (the simple tier and ensembles): one row a trajectory
# ---------------------------------------------------------------------------
#
# The JAX package checks each trajectory's termination inside ``vmap``;
# here the state holds one row a trajectory on the device, and a check is
# tensor operations on all rows (no host read).  The logic is the JAX
# package's ``check_termination`` with a leading batch dimension.


def _rows_norm(name: str, x: torch.Tensor) -> torch.Tensor:
    """The norm of each row of ``x`` (B, n) -> (B,); NaN propagates."""
    if name == "linf":
        return torch.linalg.vector_norm(x, ord=float("inf"), dim=-1)
    return torch.linalg.vector_norm(x, dim=-1)


@dataclasses.dataclass(frozen=True)
class BatchTermState:
    """``TermState`` with one row a trajectory, on the device: (B,) and
    (B, k) tensors (None where the mode keeps no such field)."""

    retcode: torch.Tensor
    nsteps: torch.Tensor
    best_objective: torch.Tensor
    initial_objective: Any
    best_u: Any
    objectives_trace: Any
    u0_norm: Any
    step_norm_trace: Any


def _rows_objective(cfg: TerminationCondition, fu, u, reltol):
    nrm = _rows_norm(cfg.norm, fu)
    if cfg.is_relative:
        npdt = real_np_dtype(u.dtype)
        eps_at = float(npdt(np.finfo(npdt).eps) * npdt(reltol))
        return nrm / (_rows_norm(cfg.norm, fu + u) + eps_at)
    return nrm


def init_termination_batched(cfg: TerminationCondition, fu, u,
                             reltol) -> BatchTermState:
    """``init_termination`` for rows ``fu`` (B, m), ``u`` (B, n)."""
    B, dev, dtype = u.shape[0], u.device, u.dtype
    initial = objectives_trace = u0_norm = step_norm_trace = None
    if cfg.is_safe:
        initial = _rows_objective(cfg, fu, u, reltol)
        best = initial
        objectives_trace = torch.zeros(B, cfg.patience_steps, dtype=dtype,
                                       device=dev)
        if cfg.max_stalled_steps is not None:
            step_norm_trace = torch.zeros(B, cfg.max_stalled_steps,
                                          dtype=dtype, device=dev)
            if cfg.is_relative:
                u0_norm = _rows_norm("l2", u)
    else:
        best = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    return BatchTermState(
        retcode=torch.full((B,), int(ReturnCode.Default), dtype=torch.int32,
                           device=dev),
        nsteps=torch.zeros(B, dtype=torch.int32, device=dev),
        best_objective=best, initial_objective=initial,
        best_u=u if cfg.keeps_best else None,
        objectives_trace=objectives_trace, u0_norm=u0_norm,
        step_norm_trace=step_norm_trace)


def _rows_plain_converged(cfg, fu, u, abstol, reltol):
    if cfg.mode == "rel":
        return (fu.abs() <= reltol * (u + fu).abs()).all(-1)
    if cfg.mode == "abs":
        return (fu.abs() <= abstol).all(-1)
    fu_norm = _rows_norm(cfg.norm, fu)
    if cfg.mode == "abs_norm":
        return fu_norm <= abstol
    both = _rows_norm(cfg.norm, fu + u)
    if cfg.mode == "norm":
        return (fu_norm <= abstol) | (fu_norm <= reltol * both)
    return fu_norm <= reltol * both                       # rel_norm


def _push(ring: torch.Tensor, nsteps: torch.Tensor, value: torch.Tensor,
          live: torch.Tensor) -> torch.Tensor:
    """Write ``value`` into slot (nsteps - 1) mod k of each live row."""
    slot = torch.remainder(nsteps - 1, ring.shape[1]).long()[:, None]
    return torch.where(live[:, None],
                       ring.scatter(1, slot, value[:, None]), ring)


def check_termination_batched(cfg: TerminationCondition,
                              state: BatchTermState, fu, u, uprev, abstol,
                              reltol, *, is_least_squares: bool = False):
    """One check of every row; returns ``(stop, new_state)``, ``stop`` a
    (B,) bool tensor.  ``abstol`` / ``reltol``: host scalars of the
    working dtype.  The safe modes in the reference's order, as
    ``check_termination``."""
    code = functools.partial(torch.full_like, state.retcode)
    if not cfg.is_safe:
        converged = _rows_plain_converged(cfg, fu, u, float(abstol),
                                          float(reltol))
        return converged, dataclasses.replace(
            state, retcode=torch.where(converged,
                                       code(int(ReturnCode.Success)),
                                       state.retcode))

    npdt = real_np_dtype(u.dtype)
    abstol, reltol = npdt(abstol), npdt(reltol)
    objective = _rows_objective(cfg, fu, u, reltol)
    criteria = float(reltol if cfg.is_relative else abstol)
    stalled_code = int(ReturnCode.StalledSuccess if is_least_squares
                       else ReturnCode.Stalled)

    stop = ~torch.isfinite(objective)
    retcode = torch.where(stop, code(int(ReturnCode.Unstable)),
                          code(int(ReturnCode.Failure)))
    if cfg.protective_threshold is not None:
        limit = state.initial_objective * cfg.protective_threshold \
            * fu.shape[-1]
        diverged = (objective > limit) & ~stop
        stop = stop | diverged
        retcode = torch.where(diverged, code(int(ReturnCode.Unstable)),
                              retcode)

    best_objective, best_u = state.best_objective, state.best_u
    if cfg.keeps_best:
        is_best = (objective < state.best_objective) & ~stop
        best_objective = torch.where(is_best, objective, best_objective)
        best_u = torch.where(is_best[:, None], u, best_u)

    converged = (objective <= criteria) & ~stop
    stop = stop | converged
    retcode = torch.where(converged, code(int(ReturnCode.Success)), retcode)

    # patience: the objectives ring, counted on non-stopping checks only
    live = ~stop
    nsteps = state.nsteps + live.to(torch.int32)
    initial = torch.where(live & (nsteps == 1), objective,
                          state.initial_objective)
    objectives_trace = _push(state.objectives_trace, nsteps, objective, live)
    P = cfg.patience_steps
    filled = torch.arange(P, device=u.device)[None, :] < \
        torch.clamp(nsteps, max=P)[:, None]
    min_obj = torch.where(filled, objectives_trace, float("inf")).amin(-1)
    max_obj = torch.where(filled, objectives_trace, float("-inf")).amax(-1)
    patience_bar = float(npdt(cfg.patience_objective_multiplier)
                         * npdt(criteria))
    patience_hit = (live & (objective <= patience_bar) & (nsteps > P)
                    & (min_obj < cfg.min_max_factor * max_obj))
    stop = stop | patience_hit
    retcode = torch.where(patience_hit, code(stalled_code), retcode)

    step_norm_trace = state.step_norm_trace
    if step_norm_trace is not None:
        du_norm = _rows_norm("l2", u - uprev)
        step_norm_trace = _push(step_norm_trace, nsteps, du_norm, live)
        max_step = step_norm_trace.amax(-1)
        if cfg.is_relative:
            stalled_step = max_step <= float(reltol) * (max_step
                                                        + state.u0_norm)
        else:
            stalled_step = max_step <= float(abstol)
        stall_hit = (live & ~patience_hit
                     & (nsteps > cfg.max_stalled_steps) & stalled_step)
        stop = stop | stall_hit
        retcode = torch.where(stall_hit, code(stalled_code), retcode)

    return stop, BatchTermState(
        retcode=retcode, nsteps=nsteps, best_objective=best_objective,
        initial_objective=initial, best_u=best_u,
        objectives_trace=objectives_trace, u0_norm=state.u0_norm,
        step_norm_trace=step_norm_trace)

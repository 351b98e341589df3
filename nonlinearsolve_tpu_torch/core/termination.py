"""Termination conditions (the port of ``core/termination.py``): the
absolute-norm family — ``abs_norm``, ``abs_norm_safe`` and
``abs_norm_safe_best`` (the default, with ``max_stalled_steps=32``).  The
relative and element-wise modes are ROADMAP A.33.

A check needs two norms of device tensors — the objective ‖fu‖ and, for
the stall test, ‖u - u_prev‖.  ``termination_norms`` gives them as 0-d
device tensors so the engine can read them in the same host sync as its
own scalars; the rest of the logic runs on the host in the working dtype.
The retained best iterate is a reference to a device tensor, never a copy.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from .._backend import fetch, np_dtype
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
    """Static termination config (defaults as the JAX package's)."""

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
        if self.mode not in ABS_NORM_MODES:
            raise NotImplementedError(
                f"termination mode {self.mode!r} is ROADMAP A.33; "
                f"the port has {ABS_NORM_MODES}")

    @property
    def is_safe(self) -> bool:
        return self.mode in SAFE_MODES

    @property
    def keeps_best(self) -> bool:
        return self.mode in BEST_MODES


def AbsNormTerminationMode(norm="l2", **kw):
    return TerminationCondition(mode="abs_norm", norm=norm, **kw)


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
    step_norm_trace: Any

    def replace(self, **kw) -> "TermState":
        return dataclasses.replace(self, **kw)


def termination_norms(cfg: TerminationCondition, fu, u=None, uprev=None):
    """The device scalars a check reads: [objective] plus ‖u - uprev‖ when
    the stall test is on and ``uprev`` is given."""
    out = [apply_norm(cfg.norm, fu)]
    if uprev is not None and cfg.is_safe and cfg.max_stalled_steps is not None:
        out.append(l2_norm(u - uprev))
    return out


def init_termination(cfg: TerminationCondition, fu, u, reltol, *,
                     norms=None) -> TermState:
    """``norms``: host values of ``termination_norms(cfg, fu)`` when the
    caller has already read them; otherwise they are read here."""
    npdt = np_dtype(u.dtype)
    if cfg.is_safe:
        objective = (norms if norms is not None
                     else fetch(*termination_norms(cfg, fu)))[0]
        initial, best = objective, objective
        objectives_trace = np.zeros(cfg.patience_steps, npdt)
        step_norm_trace = (np.zeros(cfg.max_stalled_steps, npdt)
                           if cfg.max_stalled_steps is not None else None)
    else:
        initial = objectives_trace = step_norm_trace = None
        best = npdt(np.inf)
    return TermState(retcode=int(ReturnCode.Default), nsteps=0,
                     best_objective=best, initial_objective=initial,
                     best_u=u if cfg.keeps_best else None,
                     objectives_trace=objectives_trace,
                     step_norm_trace=step_norm_trace)


def check_termination(cfg: TerminationCondition, state: TermState, fu, u,
                      uprev, abstol, reltol, *, norms=None):
    """One termination check; returns ``(stop, new_state)``.

    Safe-mode logic in the reference's order: non-finite → Unstable;
    protective threshold → Unstable; best retention; main criterion →
    Success; patience → Stalled; step-norm stall → Stalled.  ``abstol`` is a
    host scalar of the working dtype; ``norms`` as for ``init_termination``
    (with the step norm)."""
    if norms is None:
        norms = fetch(*termination_norms(cfg, fu, u, uprev))
    objective = norms[0]
    if not cfg.is_safe:
        converged = bool(objective <= abstol)
        retcode = int(ReturnCode.Success) if converged else state.retcode
        return converged, state.replace(retcode=retcode)

    npdt = type(state.best_objective)
    criteria = npdt(abstol)
    stop = False
    retcode = int(ReturnCode.Failure)

    if not np.isfinite(objective):
        stop, retcode = True, int(ReturnCode.Unstable)

    if cfg.protective_threshold is not None and not stop:
        if objective > (state.initial_objective
                        * npdt(cfg.protective_threshold) * fu.numel()):
            stop, retcode = True, int(ReturnCode.Unstable)

    best_objective, best_u = state.best_objective, state.best_u
    if cfg.keeps_best and objective < state.best_objective and not stop:
        best_objective, best_u = objective, u

    if objective <= criteria and not stop:
        stop, retcode = True, int(ReturnCode.Success)

    # patience: objectives ring, counted on non-stopping checks only
    live = not stop
    nsteps = state.nsteps + (1 if live else 0)
    initial = (objective if live and nsteps == 1
               else state.initial_objective)
    objectives_trace = state.objectives_trace
    if live:
        objectives_trace = objectives_trace.copy()
        objectives_trace[(nsteps - 1) % cfg.patience_steps] = objective
    stalled_code = int(ReturnCode.Stalled)  # StalledSuccess: least squares
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
            step_norm_trace[(nsteps - 1) % cfg.max_stalled_steps] = norms[1]
        if (live and not patience_hit and nsteps > cfg.max_stalled_steps
                and step_norm_trace.max() <= abstol):
            stop, retcode = True, stalled_code

    return stop, TermState(
        retcode=retcode, nsteps=nsteps, best_objective=best_objective,
        initial_objective=initial, best_u=best_u,
        objectives_trace=objectives_trace, step_norm_trace=step_norm_trace)


def termination_result(cfg: TerminationCondition, state: TermState,
                       fallback_u):
    """Safe-best modes return the retained best iterate."""
    if cfg.keeps_best and state.best_u is not None:
        return state.best_u
    return fallback_u

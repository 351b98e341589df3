"""Iteration traces (the port of ``core/tracing.py``): the ``show_trace``,
``store_trace`` and ``trace_level`` solve options.

Levels: ``TraceMinimal`` (iteration, ‖f‖, ‖δu‖),
``TraceWithJacobianConditionNumber`` (+ cond(J) of a dense square J) and
``TraceAll`` (+ a copy of each iterate).  A stored trace is a ring of
``buffer`` entries on the device, written in place each step with no host
read; ``show_trace`` prints each step (one host read a step).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .._backend import fetch
from ..utils.norms import l2_norm


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    store: bool = False
    show: bool = False
    level: str = "minimal"     # 'minimal' | 'condition' | 'all'
    buffer: int = 128          # stored-entry capacity (a ring)

    @property
    def active(self) -> bool:
        return self.store or self.show

    def replace(self, **kw) -> "TraceConfig":
        return dataclasses.replace(self, **kw)


def TraceMinimal(**kw):
    return TraceConfig(level="minimal", **kw)


def TraceWithJacobianConditionNumber(**kw):
    return TraceConfig(level="condition", **kw)


def TraceAll(**kw):
    return TraceConfig(level="all", **kw)


def trace_config(show_trace, store_trace, trace_level) -> Optional[TraceConfig]:
    """The solve options as one config (None when tracing is off)."""
    if not (show_trace or store_trace or trace_level is not None):
        return None
    cfg = (trace_level if isinstance(trace_level, TraceConfig)
           else TraceConfig(level=trace_level or "minimal"))
    return cfg.replace(show=bool(show_trace), store=bool(store_trace))


@dataclasses.dataclass
class TraceState:
    """The ring on the device; ``n`` (host) counts the recorded steps."""

    n: int
    fnorm: Any
    dunorm: Any
    condJ: Any = None
    u_history: Any = None


@dataclasses.dataclass(frozen=True)
class Trace:
    """The stored trace (``NonlinearSolution.trace``)."""

    n: int
    fnorm: Any
    dunorm: Any
    condJ: Any = None
    u_history: Any = None

    def __repr__(self):
        lines = ["iter      ‖f‖           ‖δu‖" +
                 ("          cond(J)" if self.condJ is not None else "")]
        for i in range(min(self.n, self.fnorm.shape[0])):
            row = f"{i + 1:5d}  {float(self.fnorm[i]):12.6e}  " \
                  f"{float(self.dunorm[i]):12.6e}"
            if self.condJ is not None:
                row += f"  {float(self.condJ[i]):12.6e}"
            lines.append(row)
        return "\n".join(lines)


def init_trace(cfg: Optional[TraceConfig], u0) -> Optional[TraceState]:
    if cfg is None or not cfg.active:
        return None
    b, dt, dev = cfg.buffer, u0.dtype, u0.device
    return TraceState(
        n=0, fnorm=torch.zeros(b, dtype=dt, device=dev),
        dunorm=torch.zeros(b, dtype=dt, device=dev),
        condJ=(torch.zeros(b, dtype=dt, device=dev)
               if cfg.level in ("condition", "all") else None),
        u_history=(torch.zeros((b, u0.numel()), dtype=dt, device=dev)
                   if cfg.level == "all" else None))


def record_trace(cfg: Optional[TraceConfig], state: Optional[TraceState],
                 nsteps, fu, du, J, u) -> Optional[TraceState]:
    """Record one step in place (returns ``state``)."""
    if cfg is None or not cfg.active or state is None:
        return state
    fnorm, dunorm = l2_norm(fu), l2_norm(du)
    if cfg.show:
        f, d = fetch(fnorm, dunorm)
        print(f"iter {nsteps}: ‖f‖={f:.6e}  ‖δu‖={d:.6e}")
    slot = state.n % cfg.buffer
    state.fnorm[slot] = fnorm
    state.dunorm[slot] = dunorm
    if (state.condJ is not None and isinstance(J, torch.Tensor)
            and J.dim() == 2 and J.shape[0] == J.shape[1]):
        sv = torch.linalg.svdvals(J)
        tiny = torch.finfo(sv.dtype).tiny
        state.condJ[slot] = sv[0] / torch.where(
            sv[-1] == 0, torch.full_like(sv[-1], tiny), sv[-1])
    if state.u_history is not None:
        state.u_history[slot] = u.reshape(-1)
    state.n += 1
    return state


def finalize_trace(cfg: Optional[TraceConfig],
                   state: Optional[TraceState]) -> Optional[Trace]:
    if cfg is None or not cfg.store or state is None:
        return None
    return Trace(n=state.n, fnorm=state.fnorm, dunorm=state.dunorm,
                 condJ=state.condJ, u_history=state.u_history)

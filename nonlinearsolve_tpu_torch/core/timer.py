"""Per-phase solve timing (the port of ``core/timer.py``):
``solve(..., time_phases=True)``.

The engines mark the boundaries of a step's phases ("jacobian",
"descent", "linesearch" — the globalization — and "other"); each mark
takes a host timestamp and the segment up to the next mark is counted to
the phase that opened it.  On the card a mark first waits for the device
(``torch.cuda.synchronize``), so a segment holds the device work of its
phase; that wait happens only when timing is on.
"""

from __future__ import annotations

import time
from typing import Dict

import torch

PHASES = ("jacobian", "descent", "linesearch", "other")


class PhaseTimer:
    """Host-side accumulator of phase marks, one a timed solve."""

    def __init__(self, device=None):
        self._events = []     # (phase index, perf_counter)
        self._cuda = device is not None and torch.device(device).type == "cuda"

    def mark(self, phase: str) -> None:
        """Open a segment attributed to ``phase``."""
        if self._cuda:
            torch.cuda.synchronize()
        self._events.append((PHASES.index(phase), time.perf_counter()))

    def summarize(self) -> Dict[str, float]:
        """Seconds per phase, ``total`` (first to last mark) and
        ``n_marks``."""
        totals = {p: 0.0 for p in PHASES}
        ev = self._events
        for (pid, t0), (_, t1) in zip(ev, ev[1:]):
            totals[PHASES[pid]] += t1 - t0
        totals["total"] = ev[-1][1] - ev[0][1] if len(ev) >= 2 else 0.0
        totals["n_marks"] = len(ev)
        return totals

    def report(self) -> str:
        s = self.summarize()
        lines = [f"{'phase':<12s}{'seconds':>12s}{'share':>9s}"]
        tot = s["total"] or 1.0
        for p in PHASES:
            lines.append(f"{p:<12s}{s[p]:>12.6f}{s[p] / tot:>8.1%}")
        lines.append(f"{'total':<12s}{s['total']:>12.6f}")
        return "\n".join(lines)

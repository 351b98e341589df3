"""Homotopy continuation methods (the port of ``solvers/homotopy.py``).

* ``HomotopySweep``: natural-parameter continuation.  A cold anchor solve
  at λspan[0]; a secant or constant predictor with trust-hysteresis
  quality gating (θ < ½ earns trust, two good steps in a row arm the
  secant); an adaptive dλ that grows after a streak of successes, gated by
  the prediction's quality and the AUTO-07p effort bands, and halves on a
  rejection down to min_dλ; loose tracking caps on the interior solves,
  from which the anchor and the landing on λspan[1] are exempt.
* ``KantorovichHomotopy``: Deuflhard's step control from the contraction
  Θ of one Newton step at the predictor point.
* ``ArcLengthContinuation``: Keller pseudo-arclength in the packed
  (u, λ) variable with the θ-weighted metric
  ``⟨x,y⟩_θ = (θ/n)⟨x_u,y_u⟩ + (1-θ)x_λy_λ``, secant or tangent
  predictors, the bordered corrector solved by the inner engine on the
  augmented (n+1) flat problem, bend-angle step control and a final
  λ-fixed landing solve.
* ``HomotopyPolyAlgorithm``: the stages in order (sweep → arclength by
  default) with a warm handoff: a failed stage hands its last accepted
  point, backed off 5% of the span, to the next one, whose step caps are
  rescaled to the remaining width.

The methods take the three-argument residual ``f(u, p, λ)`` of a
``HomotopyProblem`` on the flattened state, with λ a 0-d tensor of
``u0``'s dtype on ``u0``'s device.  Each runs as a Python loop where the
JAX package has a ``lax.while_loop``: a continuation step is one inner
solve (its engine reads once a step, as in any solve) and one host read of
the step's own device scalars (the secant quality's norms, Kantorovich's
Θ, arclength's segment norm, bend and λ); the step control then runs on
the host in the state's dtype.  The winning rung of a polyalgorithm
inner at the anchor warm-starts every tracking solve
(``run_polyalg(start_hint=)``).

A ``p`` that carries a gradient gets the implicit-function rule at the
landing point (``core/sensitivity.py``, forced onto its dense branch: a
dense forward Jacobian and an LU at every size, as the JAX package's
``_homotopy_root_jvp``): λ is λspan[1] on ``Success``, else the last λ
clipped to the span.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from .. import _backend
from ..core.autodiff import jacfwd
from ..core.descent import DescentCtx
from ..core.jacobian import JacobianSpec
from ..core.problems import HomotopyProblem
from ..core.returncode import ReturnCode
from ..core.solution import NLStats, NonlinearSolution
from ..core.termination import default_termination_mode
from ..utils.norms import get_tolerance, l2_norm
from ..utils.pytree import ravel_pytree


def _default_inner():
    from .polyalg import FastShortcutNonlinearPolyalg
    return FastShortcutNonlinearPolyalg()


@dataclasses.dataclass(frozen=True)
class HomotopySweep:
    inner: Any = None
    nsteps: Optional[int] = None
    adaptive: bool = True
    initial_step_factor: float = 0.1
    min_dlam: Optional[float] = None
    max_step_factor: float = 1.0
    expand_factor: float = 2.0
    expand_threshold: int = 2
    expand_quality: float = 0.25
    predictor: str = "secant"
    tracking_maxiters: Optional[int] = 10
    tracking_abstol: Optional[float] = None
    maxsteps: int = 10000
    name: str = "HomotopySweep"

    def __post_init__(self):
        if not self.adaptive and self.nsteps is None:
            raise ValueError("non-adaptive HomotopySweep requires nsteps")
        if self.predictor not in ("secant", "constant"):
            raise ValueError("predictor must be 'secant' or 'constant'")
        if self.nsteps is not None and self.nsteps < 1:
            raise ValueError("nsteps must be >= 1")
        if not 0.0 < self.initial_step_factor <= 1.0:
            raise ValueError("initial_step_factor must be in (0, 1]")
        if self.min_dlam is not None and not self.min_dlam > 0.0:
            raise ValueError("min_dlam must be > 0")
        if not 0.0 < self.max_step_factor <= 1.0:
            raise ValueError("max_step_factor must be in (0, 1]")
        if not self.expand_factor >= 1.0:
            raise ValueError("expand_factor must be >= 1")
        if self.expand_threshold < 1:
            raise ValueError("expand_threshold must be >= 1")
        if not self.expand_quality > 0.0:
            raise ValueError("expand_quality must be > 0")
        if self.maxsteps < 1:
            raise ValueError("maxsteps must be >= 1")
        if self.tracking_maxiters is not None and self.tracking_maxiters < 1:
            raise ValueError("tracking_maxiters must be >= 1")
        if self.tracking_abstol is not None and not self.tracking_abstol > 0:
            raise ValueError("tracking_abstol must be > 0")


@dataclasses.dataclass(frozen=True)
class KantorovichHomotopy:
    inner: Any = None
    nsteps: Optional[int] = None
    initial_step_factor: float = 0.1
    min_dlam: Optional[float] = None
    max_step_factor: float = 1.0
    qmin: float = 0.2
    qmax: float = 5.0
    theta_min: float = 0.125
    theta_reject: float = 0.95
    theta_bar: float = 0.5
    gamma: float = 0.95
    strict: bool = True
    predictor: str = "constant"
    predictor_order: Optional[int] = None  # resolved: 1 constant, 2 secant
    expand_quality: float = 0.25
    tracking_maxiters: Optional[int] = 10
    maxsteps: int = 10000
    name: str = "KantorovichHomotopy"
    # fields of the shared sweep loop (its growth path is unused)
    adaptive: bool = True
    expand_factor: float = 1.0
    expand_threshold: int = 2
    tracking_abstol: Optional[float] = None

    def __post_init__(self):
        if self.nsteps is not None and self.nsteps < 1:
            raise ValueError("nsteps must be >= 1")
        if not self.initial_step_factor > 0.0:
            raise ValueError("initial_step_factor must be > 0")
        if self.min_dlam is not None and not self.min_dlam > 0.0:
            raise ValueError("min_dlam must be > 0")
        if not 0.0 < self.max_step_factor <= 1.0:
            raise ValueError("max_step_factor must be in (0, 1]")
        if not self.qmin < 1.0:
            raise ValueError("qmin must be < 1")
        if not self.qmax >= 1.0:
            raise ValueError("qmax must be >= 1")
        if not self.theta_min < self.theta_bar:
            raise ValueError("theta_min must be < theta_bar")
        if not self.theta_bar < self.theta_reject:
            raise ValueError("theta_bar must be < theta_reject")
        if not 0.0 < self.gamma < 1.0:
            raise ValueError("gamma must be in (0, 1)")
        if self.predictor not in ("constant", "secant"):
            raise ValueError("predictor must be 'constant' or 'secant'")
        if self.predictor_order is None:
            object.__setattr__(self, "predictor_order",
                               2 if self.predictor == "secant" else 1)
        if self.predictor_order < 1:
            raise ValueError("predictor_order must be >= 1")
        if not self.expand_quality > 0.0:
            raise ValueError("expand_quality must be > 0")
        if self.tracking_maxiters is not None and self.tracking_maxiters < 1:
            raise ValueError("tracking_maxiters must be >= 1")
        if self.tracking_abstol is not None and not self.tracking_abstol > 0:
            raise ValueError("tracking_abstol must be > 0")
        if self.maxsteps < 1:
            raise ValueError("maxsteps must be >= 1")


@dataclasses.dataclass(frozen=True)
class ArcLengthContinuation:
    inner: Any = None
    initial_step_factor: float = 0.1
    adaptive: bool = True
    min_ds: Optional[float] = None
    max_step_factor: float = 1.0
    expand_factor: float = 2.0
    expand_threshold: int = 2
    max_angle: float = math.pi / 6
    predictor: str = "secant"
    tracking_maxiters: Optional[int] = 10
    maxsteps: int = 10000
    theta: float = 0.5
    name: str = "ArcLengthContinuation"

    def __post_init__(self):
        if not 0.0 < self.initial_step_factor <= 1.0:
            raise ValueError("initial_step_factor must be in (0, 1]")
        if self.min_ds is not None and not self.min_ds > 0.0:
            raise ValueError("min_ds must be > 0")
        if not 0.0 < self.max_step_factor <= 1.0:
            raise ValueError("max_step_factor must be in (0, 1]")
        if not self.expand_factor >= 1.0:
            raise ValueError("expand_factor must be >= 1")
        if self.expand_threshold < 1:
            raise ValueError("expand_threshold must be >= 1")
        if not 0.0 < self.max_angle < math.pi:
            raise ValueError("max_angle must be in (0, pi)")
        if self.predictor not in ("secant", "tangent"):
            # 'constant' is refused: the augmented corrector needs a
            # direction
            raise ValueError("predictor must be 'secant' or 'tangent'")
        if self.maxsteps < 1:
            raise ValueError("maxsteps must be >= 1")
        if not 0.0 < self.theta < 1.0:
            raise ValueError("theta must be in (0, 1) — either endpoint "
                             "degenerates the arclength metric")
        if self.tracking_maxiters is not None and self.tracking_maxiters < 1:
            raise ValueError("tracking_maxiters must be >= 1")


@dataclasses.dataclass(frozen=True)
class HomotopyPolyAlgorithm:
    stages: Tuple[Any, ...] = ()
    warm_handoff: bool = True
    name: str = "HomotopyPolyAlgorithm"

    def __post_init__(self):
        if not self.stages:
            object.__setattr__(
                self, "stages", (HomotopySweep(), ArcLengthContinuation()))


def FastShortcutHomotopyPolyalg(*, autodiff=None, warm_handoff=True):
    """Sweep → arclength with a FastShortcut inner corrector."""
    from .polyalg import FastShortcutNonlinearPolyalg
    inner = FastShortcutNonlinearPolyalg(autodiff=autodiff)
    return HomotopyPolyAlgorithm(
        stages=(HomotopySweep(inner=inner),
                ArcLengthContinuation(inner=inner)),
        warm_handoff=warm_handoff)


def SimpleHomotopySweep(**kw):
    """The sweep with a SimpleNewtonRaphson corrector."""
    from .simple import SimpleNewtonRaphson
    kw.setdefault("inner", SimpleNewtonRaphson())
    return HomotopySweep(**kw)


# ---------------------------------------------------------------------------
# the flat problem a continuation method runs on
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Flat:
    """``f(u, p, λ)`` on the flattened state, and the inner solves."""

    f_raw: Any
    p: Any
    unravel: Any                 # the flat state -> u0's tree
    n: int
    dtype: torch.dtype
    device: torch.device
    inner: Any
    reltol: Any

    def lam(self, value) -> torch.Tensor:
        """λ as a 0-d tensor (a fill: no copy from the host)."""
        return torch.full((), float(value), dtype=self.dtype,
                          device=self.device)

    def f_at(self, lam):
        """u_flat -> H(u, p, λ) flat; ``lam`` a tensor or a host scalar."""
        lam_t = lam if isinstance(lam, torch.Tensor) else self.lam(lam)

        def f_flat(u):
            return self.keep_dtype(ravel_pytree(
                self.f_raw(self.unravel(u), self.p, lam_t))[0])
        return f_flat

    def keep_dtype(self, out):
        """``out`` with a tangent of the state's dtype under
        ``torch.func.jvp``, where a 0-d f32 tensor combined with a Python
        float carries an f64 tangent (and an f64 Jacobian would make the
        Newton step, and then the iterate, f64)."""
        if self.dtype == torch.float64:
            return out
        return out.to(self.dtype, copy=True)

    def run(self, f_flat, n, guess, budget, tol, hint=None):
        """One inner solve of ``f_flat`` (n unknowns) from ``guess``."""
        from .dispatch import run_algorithm
        from .polyalg import NonlinearSolvePolyAlgorithm, run_polyalg
        ctx = DescentCtx(f_flat=f_flat, n_in=n, n_out=n,
                         is_least_squares=False, out_shape=(n,))
        term_cfg = default_termination_mode(False)
        if isinstance(self.inner, NonlinearSolvePolyAlgorithm):
            return run_polyalg(self.inner, ctx, term_cfg, JacobianSpec(),
                               guess, tol, self.reltol, int(budget),
                               start_hint=hint)
        return run_algorithm(self.inner, ctx, term_cfg, JacobianSpec(),
                             guess, tol, self.reltol, int(budget))

    def run_inner(self, guess, lam, budget, tol, hint=None):
        return self.run(self.f_at(lam), self.n, guess, budget, tol, hint)


def _add(stats: NLStats, s: NLStats) -> NLStats:
    return stats.incr(nf=s.nf, njacs=s.njacs, nfactors=s.nfactors,
                      nsolve=s.nsolve, nsteps=s.nsteps)


def _winner(carry) -> int:
    return max(getattr(carry, "winner", -1), 0)


# ---------------------------------------------------------------------------
# natural-parameter sweep (HomotopySweep and KantorovichHomotopy)
# ---------------------------------------------------------------------------

def _effort_growth_factor(nit, budget, expand_factor):
    """The AUTO-07p effort bands."""
    band1 = max(3, budget // 20)
    band2 = max(6, budget // 4)
    one = type(expand_factor)(1)
    if nit < 0 or nit <= band1:
        return expand_factor
    if nit <= band2:
        return one + (expand_factor - one) / type(expand_factor)(2)
    return one


def _effort_wants_shrink(nit, budget) -> bool:
    return 0 <= nit <= budget and 4 * nit >= 3 * budget


def _kantorovich_q(alg: KantorovichHomotopy, theta, has_theta, npdt):
    """The step factor from Θ, in the state's dtype."""
    def g(x):
        return np.sqrt(npdt(1.0) + npdt(4.0) * x) - npdt(1.0)

    theta_eff = (np.maximum(theta, npdt(alg.theta_min)) if has_theta
                 else npdt(alg.theta_min))
    q = npdt(alg.gamma) * (g(npdt(alg.theta_bar)) / g(theta_eff)) \
        ** npdt(1.0 / alg.predictor_order)
    q = np.clip(q, npdt(alg.qmin), npdt(alg.qmax))
    if has_theta and (not np.isfinite(theta) or theta < 0):
        return npdt(alg.qmin)
    return q


def _contraction_probe(f_flat, guess):
    """One Newton step at the predictor point: the device scalars
    Θ = ‖f(u₁)‖/‖f(guess)‖ and "the probe is usable"."""
    from ..ops.linear_solve import _lu_solve
    fu0 = f_flat(guess)
    J = jacfwd(f_flat)(guess)
    du = _lu_solve(J, fu0)
    ok = torch.isfinite(du).all()
    u1 = guess - torch.where(ok, du, torch.zeros_like(du))
    n0 = l2_norm(fu0)
    theta = l2_norm(f_flat(u1)) / torch.where(n0 == 0, torch.ones_like(n0),
                                              n0)
    return theta, ok & torch.isfinite(theta)


@dataclasses.dataclass
class _Sweep:
    """The sweep's state; the λ's and step sizes are host scalars of the
    state's dtype."""

    u: Any
    u_prev: Any
    lam: Any
    lam_prev: Any
    dlam: Any
    streak: int
    trust: int
    disp_prev: Any
    attempts: int
    fu: Any
    retcode: int
    done: bool
    stats: NLStats
    alg_hint: int


def _run_sweep(alg, flat: _Flat, u0, lam0, lam1, abstol, maxiters,
               kantorovich: bool, user_tol: bool, user_maxiters: bool):
    """The shared natural-parameter loop.  Explicit user tolerances and
    budgets win over the loose interior-tracking ones."""
    npdt = _backend.np_dtype(u0.dtype)
    lam0, lam1 = npdt(lam0), npdt(lam1)
    span = lam1 - lam0
    if alg.nsteps is not None:
        dlam0 = span / npdt(alg.nsteps)
    else:
        dlam0 = npdt(alg.initial_step_factor) * span
    sqrt_eps = np.sqrt(np.finfo(npdt).eps)
    min_dlam = sqrt_eps if alg.min_dlam is None else npdt(alg.min_dlam)
    max_dlam = npdt(alg.max_step_factor) * span
    if abs(dlam0) > abs(max_dlam):
        dlam0 = max_dlam
    track_budget = (maxiters if (user_maxiters
                                 or alg.tracking_maxiters is None)
                    else int(alg.tracking_maxiters))
    track_abstol = (abstol if (user_tol or alg.tracking_abstol is None)
                    else npdt(alg.tracking_abstol))

    # the anchor at λ0, with the full budget and tolerance; its winning
    # rung warm-starts the tracking solves
    anchor = flat.run_inner(u0, lam0, maxiters, abstol, 0)
    anchor_ok = ReturnCode.successful(anchor.retcode)
    # an anchor that fails returns u0 itself with its residual
    c = _Sweep(
        u=anchor.u if anchor_ok else u0,
        u_prev=anchor.u if anchor_ok else u0, lam=lam0, lam_prev=lam0,
        dlam=dlam0, streak=0, trust=2, disp_prev=npdt(0), attempts=0,
        fu=anchor.fu if anchor_ok else flat.f_at(lam0)(u0),
        retcode=int(ReturnCode.Default),
        done=(not anchor_ok) or lam0 == lam1, stats=anchor.stats,
        alg_hint=_winner(anchor))

    while not c.done:
        _sweep_step(alg, flat, c, lam1, min_dlam, max_dlam, track_budget,
                    track_abstol, abstol, maxiters, kantorovich, sqrt_eps,
                    npdt)

    if not anchor_ok:
        retcode = anchor.retcode
    elif lam0 == lam1:
        retcode = int(ReturnCode.Success)
    else:
        retcode = c.retcode
    return c.u, c.fu, retcode, c.stats, c.lam


def _sweep_step(alg, flat, c: _Sweep, lam1, min_dlam, max_dlam,
                track_budget, track_abstol, abstol, maxiters, kantorovich,
                sqrt_eps, npdt) -> None:
    """One continuation step (an attempt, accepted or rejected), in
    place: one inner solve and one host read."""
    attempts = c.attempts + 1
    hit_cap = attempts > alg.maxsteps
    next_lam = lam1 if abs(lam1 - c.lam) <= abs(c.dlam) else c.lam + c.dlam
    underflow = next_lam == c.lam and next_lam != lam1
    landing = next_lam == lam1

    have_hist = c.lam_prev != c.lam
    use_secant = alg.predictor == "secant" and c.trust >= 2 and have_hist
    denom = npdt(1) if c.lam == c.lam_prev else c.lam - c.lam_prev
    s = float((next_lam - c.lam) / denom)
    virtual = c.u + s * (c.u - c.u_prev)
    guess = virtual if use_secant else c.u

    # interior tracking runs under the loose cap and tolerance; the
    # landing gets the full budget and tolerance
    budget = maxiters if landing else track_budget
    tol = abstol if landing else track_abstol
    f_next = flat.f_at(next_lam)
    inner = flat.run(f_next, flat.n, guess, budget, tol, c.alg_hint)
    ok = ReturnCode.successful(inner.retcode)

    reads = [l2_norm(inner.u - virtual), l2_norm(inner.u - c.u),
             l2_norm(inner.u)]
    if kantorovich:
        reads += list(_contraction_probe(f_next, guess))
    host = _backend.fetch(*reads)
    correction, disp, unorm = (npdt(h) for h in host[:3])
    if kantorovich:
        theta_c, has_theta = npdt(host[3]), bool(host[4])
        contraction_rejected = has_theta and theta_c > alg.theta_reject
    else:
        theta_c, has_theta, contraction_rejected = npdt(0), False, False
    strict_reject = kantorovich and alg.strict and contraction_rejected
    accepted = ok and not strict_reject

    # the secant quality θ
    scale = np.maximum(np.maximum(disp, c.disp_prev),
                       sqrt_eps * (npdt(1) + unorm))
    theta_q = correction / scale
    trust = c.trust
    if accepted and have_hist:
        trust = c.trust + 1 if theta_q < 0.5 else 0
    disp_prev = disp if accepted else c.disp_prev

    # the accepted step size
    nit = inner.stats.nsteps
    corrector_cheap = 0 <= nit <= 2
    good_quality = (not have_hist) or theta_q <= npdt(alg.expand_quality) \
        or corrector_cheap
    if kantorovich:
        q = _kantorovich_q(alg, theta_c, has_theta, npdt)
        if q > 1.0 and not good_quality:
            q = npdt(1)
        proposed = q * c.dlam
        if abs(proposed) > abs(max_dlam):
            proposed = max_dlam
        if abs(proposed) < min_dlam:
            proposed = np.sign(c.dlam) * min_dlam
        dlam_acc, streak_acc = proposed, 0
    else:
        shrink = _effort_wants_shrink(nit, budget)
        halved = c.dlam / npdt(2) if abs(c.dlam) / npdt(2) >= min_dlam \
            else c.dlam
        streak1 = c.streak + 1
        growth = _effort_growth_factor(nit, budget, npdt(alg.expand_factor))
        can_grow = (streak1 >= alg.expand_threshold and good_quality
                    and growth > 1.0)
        grown = growth * c.dlam
        if abs(grown) > abs(max_dlam):
            grown = max_dlam
        dlam_acc = halved if shrink else (grown if can_grow else c.dlam)
        streak_acc = 0 if (shrink or can_grow) else streak1
        if not alg.adaptive:
            dlam_acc, streak_acc = c.dlam, c.streak

    # the rejected step size
    if kantorovich:
        q_rej = (_kantorovich_q(alg, theta_c, True, npdt)
                 if (ok and contraction_rejected and np.isfinite(theta_c)
                     and theta_c >= 0) else npdt(alg.qmin))
        dlam_rej = q_rej * (next_lam - c.lam)
        can_retry = abs(dlam_rej) >= min_dlam and dlam_rej != 0
    else:
        dlam_rej = c.dlam / npdt(2)
        can_retry = abs(dlam_rej) >= min_dlam and alg.adaptive

    if accepted:
        c.u, c.u_prev = inner.u, c.u
        c.lam, c.lam_prev = next_lam, c.lam
        c.dlam, c.streak, c.trust = dlam_acc, streak_acc, trust
    else:
        if can_retry:
            c.dlam, c.trust = dlam_rej, 0
        c.streak = 0
    c.disp_prev = disp_prev
    c.attempts = attempts
    c.fu = inner.fu
    c.stats = _add(c.stats, inner.stats)
    c.alg_hint = _winner(inner) if ok else c.alg_hint

    finished = accepted and landing
    failed = not accepted and not can_retry
    retcode = int(ReturnCode.Default)
    if failed:
        retcode = (int(ReturnCode.ConvergenceFailure) if strict_reject
                   else int(inner.retcode))
    if underflow:
        retcode = int(ReturnCode.Stalled)
    if hit_cap:
        retcode = int(ReturnCode.MaxIters)
    if finished:
        retcode = int(ReturnCode.Success)
    c.retcode = retcode
    c.done = finished or failed or underflow or hit_cap


# ---------------------------------------------------------------------------
# pseudo-arclength
# ---------------------------------------------------------------------------

def _run_arclength(alg: ArcLengthContinuation, flat: _Flat, u0, lam0, lam1,
                   abstol, maxiters, user_maxiters: bool):
    """Keller pseudo-arclength on x = [u; λ]."""
    npdt = _backend.np_dtype(u0.dtype)
    n = flat.n
    lam0, lam1 = npdt(lam0), npdt(lam1)
    span = lam1 - lam0
    wu = alg.theta / n
    wl = 1.0 - alg.theta

    def tdot(a, b):
        return wu * torch.dot(a[:n], b[:n]) + wl * a[n] * b[n]

    def tnorm(a):
        return torch.sqrt(tdot(a, a))

    ds = abs(npdt(alg.initial_step_factor) * span)
    min_ds = (np.sqrt(np.finfo(npdt).eps) if alg.min_ds is None
              else npdt(alg.min_ds))
    max_ds = abs(npdt(alg.max_step_factor) * span)
    track_budget = (maxiters if (user_maxiters
                                 or alg.tracking_maxiters is None)
                    else int(alg.tracking_maxiters))
    max_angle = npdt(alg.max_angle)
    grow_angle = npdt(alg.max_angle / 3.0)

    anchor = flat.run_inner(u0, lam0, maxiters, abstol)
    anchor_ok = ReturnCode.successful(anchor.retcode)
    x = torch.cat([anchor.u, flat.lam(lam0)[None]])
    x_prev = x
    fu = torch.cat([anchor.fu, anchor.fu.new_zeros(1)])
    x_lam = lam0
    # the bootstrap direction: a pure-λ step toward λ1
    tau = torch.zeros(n + 1, dtype=u0.dtype, device=u0.device)
    tau[n] = float(np.sign(span) / npdt(np.sqrt(wl)))
    streak, attempts, have_hist = 0, 0, False
    retcode = int(ReturnCode.Default)
    stats = anchor.stats
    done = (not anchor_ok) or lam0 == lam1

    while not done:
        attempts += 1
        hit_cap = attempts > alg.maxsteps
        if alg.predictor == "tangent":
            tau_pred = _tangent(flat, x, tau, n, wu, wl, tnorm, tdot)
        elif have_hist:
            # the secant through the last two accepted points
            sec = x - x_prev
            sec_norm = tnorm(sec)
            tau_pred = torch.where(
                sec_norm > 0, sec / torch.where(
                    sec_norm == 0, torch.ones_like(sec_norm), sec_norm), tau)
        else:
            tau_pred = tau
        guess = x + float(ds) * tau_pred
        corr = _corrector(flat, tau_pred, x, ds, guess, track_budget,
                          abstol, wu, wl)
        ok = ReturnCode.successful(corr.retcode)
        x_new = corr.u

        # the bend-angle control
        seg = x_new - x
        seg_norm_t = tnorm(seg)
        seg_norm, bend, lam_new = _backend.fetch(seg_norm_t, tdot(seg, tau),
                                                 x_new[n])
        if have_hist and seg_norm > 0:
            cosang = bend / seg_norm
        else:
            cosang = npdt(1)
        angle = np.arccos(np.clip(cosang, npdt(-1), npdt(1)))
        too_bent = have_hist and angle > max_angle
        accepted = ok and not too_bent
        crossed = accepted and (lam_new - lam1) * np.sign(span) >= 0

        # the step size
        streak1 = streak + 1
        can_grow = streak1 >= alg.expand_threshold and angle < grow_angle
        ds_acc = (np.minimum(npdt(alg.expand_factor) * ds, max_ds)
                  if can_grow else ds)
        streak_acc = 0 if can_grow else streak1
        ds_rej = ds / npdt(2)
        can_retry = ds_rej >= min_ds
        if not alg.adaptive:
            ds_acc, streak_acc, can_retry = ds, streak, False

        if accepted:
            # the stored direction is the accepted segment (the realized
            # path direction), compared with the next one by the bend test
            if seg_norm > 0:
                tau = seg / seg_norm_t
            x, x_prev, x_lam = x_new, x, lam_new
            ds, streak = ds_acc, streak_acc
        else:
            if can_retry:
                ds = ds_rej
            streak = 0
        have_hist = have_hist or accepted
        fu = corr.fu
        stats = _add(stats, corr.stats)

        failed = not accepted and not can_retry
        retcode = int(ReturnCode.Default)
        if failed:
            retcode = int(corr.retcode)
            if too_bent and ok:
                retcode = int(ReturnCode.ConvergenceFailure)
        if hit_cap:
            retcode = int(ReturnCode.MaxIters)
        if crossed:
            retcode = int(ReturnCode.Terminated)
        done = crossed or failed or hit_cap

    # the final λ-fixed landing solve from the crossing point
    landed = flat.run_inner(x[:n], lam1, maxiters, abstol)
    landing_ok = ReturnCode.successful(landed.retcode)
    was_crossed = retcode == ReturnCode.Terminated
    if was_crossed and landing_ok:
        u_final, fu_final = landed.u, landed.fu
    else:
        u_final, fu_final = x[:n], fu[:n]
    if not anchor_ok:
        retcode = int(anchor.retcode)
    elif lam0 == lam1:
        retcode = int(ReturnCode.Success)
    elif was_crossed:
        retcode = (int(ReturnCode.Success) if landing_ok
                   else int(landed.retcode))
    return u_final, fu_final, retcode, _add(stats, landed.stats), x_lam


def _tangent(flat, x, tau, n, wu, wl, tnorm, tdot):
    """The path tangent from the bordered solve
    ``[∂H/∂u | ∂H/∂λ ; τ_prevᵀ·W] t = e_{n+1}``, oriented along τ_prev
    (τ_prev itself where the solve fails)."""
    from ..ops.linear_solve import _lu_solve

    def path_resid(xv):
        return flat.f_at(xv[n])(xv[:n])

    P = jacfwd(path_resid)(x)                                # (n, n+1)
    wrow = torch.cat([wu * tau[:n], (wl * tau[n])[None]])
    B = torch.cat([P, wrow[None, :]], dim=0)
    e = torch.zeros(n + 1, dtype=x.dtype, device=x.device)
    e[n] = 1.0
    t_raw = _lu_solve(B, e)
    t_norm = tnorm(t_raw)
    t_ok = torch.isfinite(t_raw).all() & (t_norm > 0)
    one = torch.ones_like(t_norm)
    t_unit = t_raw / torch.where(t_norm == 0, one, t_norm)
    d = tdot(t_unit, tau)
    t_unit = t_unit * torch.sign(torch.where(d == 0, one, d))
    return torch.where(t_ok, t_unit, tau)


def _corrector(flat, tau, xcur, ds, guess, budget, tol, wu, wl):
    """The inner solve of the bordered system H(u, λ) = 0,
    ⟨τ, x - x_cur⟩_θ = ds on the augmented (n+1) flat problem."""
    n = flat.n
    ds_f = float(ds)

    def aug_flat(x_vec):
        h = flat.f_at(x_vec[n])(x_vec[:n])
        cons = (wu * torch.dot(tau[:n], x_vec[:n] - xcur[:n])
                + wl * tau[n] * (x_vec[n] - xcur[n]) - ds_f)
        return torch.cat([h, flat.keep_dtype(cons[None])])

    return flat.run(aug_flat, n + 1, guess, budget, tol)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _solve_homotopy_single(prob, alg, *, abstol=None, reltol=None,
                           maxiters=None, **_ignored) -> NonlinearSolution:
    from ..core.sensitivity import (differentiable_leaves,
                                    differentiable_root, strip_tangents)
    from ..core.solve import state_device
    u0_tree = strip_tangents(prob.u0)
    u0, unravel = ravel_pytree(u0_tree,
                               device=state_device(u0_tree, prob.p))
    u0 = u0.detach()
    npdt = _backend.np_dtype(u0.dtype)
    # explicit user tolerances and budgets shadow the loose tracking ones
    user_tol = abstol is not None or reltol is not None
    user_maxiters = maxiters is not None
    maxiters = 1000 if maxiters is None else int(maxiters)
    abstol_v = npdt(get_tolerance(abstol, npdt))
    reltol_v = npdt(get_tolerance(reltol, npdt))
    lam0, lam1 = prob.lambdaspan
    p_run = strip_tangents(prob.p)
    inner = alg.inner if alg.inner is not None else _default_inner()
    flat = _Flat(f_raw=prob.f.f, p=p_run, unravel=unravel, n=u0.numel(), dtype=u0.dtype, device=u0.device,
                 inner=inner, reltol=reltol_v)
    syncs0 = _backend.HOST_SYNCS["n"]
    with torch.no_grad():
        if isinstance(alg, ArcLengthContinuation):
            u, fu, retcode, stats, lam_last = _run_arclength(
                alg, flat, u0.reshape(-1), lam0, lam1, abstol_v, maxiters,
                user_maxiters)
        else:
            u, fu, retcode, stats, lam_last = _run_sweep(
                alg, flat, u0.reshape(-1), lam0, lam1, abstol_v, maxiters,
                isinstance(alg, KantorovichHomotopy), user_tol,
                user_maxiters)
    index = differentiable_leaves(prob.p)
    if index:
        # the implicit-function rule at the landing point, dense at every n
        lo, hi = sorted((npdt(lam0), npdt(lam1)))
        lam_ift = (npdt(lam1) if retcode == ReturnCode.Success
                   else np.clip(lam_last, lo, hi))
        lam_t = flat.lam(lam_ift)
        f_raw = prob.f.f

        def residual(v, q):
            return ravel_pytree(f_raw(unravel(v), q, lam_t))[0]
        u = differentiable_root(u, residual, prob.p, index, square=True,
                                dense=True)
    return NonlinearSolution(
        u=unravel(u), resid=fu, retcode=ReturnCode(retcode),
        stats=stats, original=lam_last,
        counters={"host_syncs": _backend.HOST_SYNCS["n"] - syncs0})


def solve_homotopy(prob, alg=None, **kwargs) -> NonlinearSolution:
    """Solve a ``HomotopyProblem`` (default: ``HomotopyPolyAlgorithm``).
    ``sol.original`` is the last λ the method reached (a host scalar)."""
    if alg is None:
        alg = HomotopyPolyAlgorithm()
    if isinstance(alg, (HomotopySweep, KantorovichHomotopy,
                        ArcLengthContinuation)):
        return _solve_homotopy_single(prob, alg, **kwargs)
    if not isinstance(alg, HomotopyPolyAlgorithm):
        raise ValueError(f"cannot dispatch homotopy algorithm {alg!r}")

    # the stages with the warm handoff
    lam0, lam1 = prob.lambdaspan
    span = lam1 - lam0
    best_sol = None
    for i, stage in enumerate(alg.stages):
        sol = _solve_homotopy_single(prob, stage, **kwargs)
        if sol.success:
            return sol
        best_sol = sol
        if not alg.warm_handoff or i + 1 >= len(alg.stages):
            continue
        lam_last = float(sol.original)
        if lam_last == lam0:
            continue
        # back off 5% of the span from the last accepted point; rescale the
        # next stage's step caps to the remaining width
        lam_h = lam_last - 0.05 * span
        if (span > 0 and lam_h <= lam0) or (span < 0 and lam_h >= lam0):
            lam_h = lam0
        remaining = lam1 - lam_h
        next_stage = alg.stages[i + 1]
        rescaled = dataclasses.replace(
            next_stage, max_step_factor=min(
                1.0, next_stage.max_step_factor * abs(span / remaining))
        ) if remaining != 0 else next_stage
        warm_prob = HomotopyProblem(prob.f, sol.u, prob.p,
                                    lambdaspan=(lam_h, lam1), **prob.kwargs)
        warm_sol = _solve_homotopy_single(warm_prob, rescaled, **kwargs)
        if warm_sol.success:
            return warm_sol
        best_sol = warm_sol
    return best_sol

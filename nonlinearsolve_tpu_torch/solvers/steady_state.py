"""Steady-state solvers (the port of ``solvers/steady_state.py``):
``SSRootfind`` and ``DynamicSS``.

``SSRootfind(alg)`` solves the steady-state problem with a rootfinder:
``solve()`` unwraps it to ``alg`` (or the default polyalgorithm) on the
converted ``NonlinearProblem``.  ``DynamicSS`` integrates
``du/dt = f(u, p)`` until the derivative is near zero, so it converges to
stable equilibria only:

* ``method="tsit5"``: Tsitouras 5(4) explicit RK (FSAL: the residual in
  the carry is stage 1), PI step-size controller, and a cap on h·|λ| that
  keeps the step inside the explicit stability interval;
* ``method="rosenbrock23"``: Shampine–Reichelt ode23s, one dense forward
  Jacobian, one LU factorization (getrf; cuSOLVER on the card) and three
  solves an attempt.

An attempt (accepted or rejected) is one pass of a Python loop with one
host read: the error norm, the finiteness of the step, the derivative
test at the proposed point and (Tsit5) the two norms of the stability
estimate travel together, and the controller runs on the host in the
state's dtype, as the JAX package's ``lax.while_loop`` body does on the
device.  After an accepted step the solve stops when every component of
du/dt passes ``|du_i| ≤ abstol`` or ``|du_i| ≤ reltol·|u_i|``; reaching
``tspan`` first gives ``MaxTime``, a collapsed step ``Unstable`` and the
attempt budget ``MaxIters``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .. import _backend
from ..core.autodiff import jacfwd
from ..core.returncode import ReturnCode
from ..core.solution import NLStats


@dataclasses.dataclass(frozen=True)
class SSRootfind:
    """Solve the steady-state problem with the rootfinder ``alg`` (the
    default polyalgorithm when None)."""
    alg: Any = None


@dataclasses.dataclass(frozen=True)
class DynamicSS:
    """``method``: "tsit5" or "rosenbrock23"; ``tspan``: the simulated-time
    budget; ``dt``: the first step (Hairer's guess when None).
    ``term_abstol`` / ``term_reltol`` override the solve-level tolerances
    of the derivative test (which ``solve`` defaults to 1e-8 / 1e-6 for
    ``DynamicSS``); ``ode_abstol`` / ``ode_reltol`` control the step
    error."""
    method: str = "tsit5"
    tspan: float = float("inf")
    dt: Optional[float] = None
    term_abstol: Optional[float] = None
    term_reltol: Optional[float] = None
    ode_abstol: float = 1e-6
    ode_reltol: float = 1e-3
    safety: float = 0.9
    qmin: float = 0.2
    qmax: float = 10.0
    name: str = "DynamicSS"


@dataclasses.dataclass(frozen=True)
class SSCarry:
    u: Any
    fu: Any
    t: Any             # host scalars of the state's dtype from here on
    dt: Any
    dt_cap: Any
    err_prev: Any
    nsteps: int        # accepted steps
    attempts: int      # accepted + rejected
    force_stop: bool
    retcode: int
    stats: NLStats

    def replace(self, **kw) -> "SSCarry":
        return dataclasses.replace(self, **kw)


# Tsitouras 2011 coefficients (the standard Tsit5 tableau).
_TSIT5_A = (
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)
_TSIT5_BTILDE = (
    -0.00178001105222577714, -0.0008164344596567469, 0.007880878010261995,
    -0.1447110071732629, 0.5823571654525552, -0.45808210592918697,
    0.015151515151515152,
)


def _combo(coefs, ks):
    """Σ aᵢkᵢ, summed from 0 as the JAX package's Python ``sum`` does."""
    return sum(a * k for a, k in zip(coefs, ks))


def _err_norm(err, u, u_new, ode_abstol, ode_reltol):
    sc = ode_abstol + torch.maximum(u.abs(), u_new.abs()) * ode_reltol
    return torch.sqrt(torch.mean((err / sc) ** 2))


def _tsit5_attempt(f, u, k1, h):
    """One Tsit5 attempt from (u, k1 = f(u)); returns (u_new, k7, err,
    nf)."""
    ks = [k1]
    for row in _TSIT5_A[:-1]:
        ks.append(f(u + h * _combo(row, ks)))
    u_new = u + h * _combo(_TSIT5_A[-1], ks)
    k7 = f(u_new)          # FSAL: k7 is f at the proposed iterate
    ks.append(k7)
    return u_new, k7, h * _combo(_TSIT5_BTILDE, ks), 6


_ROS_D = 1.0 / (2.0 + 2.0 ** 0.5)
_ROS_E32 = 6.0 + 2.0 ** 0.5


def _rosenbrock23_attempt(f, u, f0, h):
    """One ode23s attempt; returns (u_new, f_new, err, nf).  ``h`` is a
    host scalar of the state's dtype: its products with constants round
    in that dtype, as the JAX package's do."""
    n = u.shape[0]
    J = jacfwd(f)(u)
    hd = float(h * type(h)(_ROS_D))
    W = torch.eye(n, dtype=u.dtype, device=u.device) - hd * J
    LU, piv, _ = torch.linalg.lu_factor_ex(W, check_errors=False)

    def solve(b):
        return torch.linalg.lu_solve(LU, piv, b[:, None])[:, 0]
    k1 = solve(f0)
    f1 = f(u + float(0.5 * h) * k1)
    k2 = k1 + solve(f1 - k1)
    u_new = u + float(h) * k2
    f2 = f(u_new)
    k3 = solve(f2 - _ROS_E32 * (k2 - f1) - 2.0 * (k1 - f0))
    return u_new, f2, float(h / type(h)(6.0)) * (k1 - 2.0 * k2 + k3), 2


def run_dynamic_ss(alg: DynamicSS, ctx, term_cfg, u0, abstol, reltol,
                   maxiters):
    """Integrate to a steady state on the flattened state; returns the
    final carry with ``u`` and ``fu`` in their shapes.  ``term_cfg`` is
    unused: the derivative test decides (module docstring)."""
    from .quasi_newton import flat_ctx
    shape = u0.shape
    fctx, seen = flat_ctx(ctx, shape)
    f = fctx.f_flat
    u = u0.reshape(-1)
    npdt = _backend.np_dtype(u.dtype)
    fu = f(u)
    order = 5.0 if alg.method == "tsit5" else 2.0
    beta1, beta2 = 0.7 / order, 0.4 / order
    tspan = npdt(alg.tspan)
    if alg.dt is not None:
        dt = npdt(alg.dt)
    else:
        # Hairer's cheap h0 guess: 0.01·(scaled |u|)/(scaled |u'|)
        sc = alg.ode_abstol + u.abs() * alg.ode_reltol
        d0, d1 = _backend.fetch(torch.sqrt(torch.mean((u / sc) ** 2)),
                                torch.sqrt(torch.mean((fu / sc) ** 2)))
        dt = (npdt(1e-6) if (d0 < 1e-5) | (d1 < 1e-5)
              else npdt(0.01) * d0 / d1)
    dt = min(dt, tspan)
    dt_min = npdt(np.finfo(npdt).eps * 1e3)
    term_abstol = float(abstol if alg.term_abstol is None
                        else npdt(alg.term_abstol))
    term_reltol = float(reltol if alg.term_reltol is None
                        else npdt(alg.term_reltol))
    carry = SSCarry(u=u, fu=fu, t=npdt(0), dt=dt, dt_cap=npdt(np.inf),
                    err_prev=npdt(1), nsteps=0, attempts=0,
                    force_stop=False, retcode=int(ReturnCode.Default),
                    stats=NLStats.zeros().incr(nf=1))
    while not carry.force_stop and carry.attempts < maxiters:
        carry = _attempt(alg, f, carry, tspan, dt_min, beta1, beta2,
                         term_abstol, term_reltol, npdt)
    retcode = carry.retcode
    if retcode == ReturnCode.Default:
        retcode = int(ReturnCode.MaxIters)
    return carry.replace(u=carry.u.reshape(shape),
                         fu=carry.fu.reshape(seen.get("fu", (-1,))),
                         retcode=retcode)


def _attempt(alg, f, c: SSCarry, tspan, dt_min, beta1, beta2, term_abstol,
             term_reltol, npdt) -> SSCarry:
    """One step attempt, accepted or rejected: one host read."""
    h = min(c.dt, tspan - c.t)
    if alg.method == "tsit5":
        u_new, f_new, err, nf = _tsit5_attempt(f, c.u, c.fu, float(h))
        counters = dict(nf=nf)
    else:
        u_new, f_new, err, nf = _rosenbrock23_attempt(f, c.u, c.fu, h)
        counters = dict(nf=nf, njacs=1, nfactors=1, nsolve=3)
    reads = [_err_norm(err, c.u, u_new, alg.ode_abstol, alg.ode_reltol),
             torch.isfinite(u_new).all(),
             # the derivative test at the proposed point (elementwise or)
             ((f_new.abs() <= term_abstol)
              | (f_new.abs() <= term_reltol * u_new.abs())).all()]
    if alg.method == "tsit5":
        reads += [torch.sqrt(torch.sum((u_new - c.u) * (u_new - c.u))),
                  torch.sqrt(torch.sum((f_new - c.fu) ** 2))]
    host = _backend.fetch(*reads)
    en = npdt(host[0])
    finite = bool(np.isfinite(en) and host[1])
    accept = finite and en <= 1.0

    # PI controller (predictive on accept, pure reject shrink otherwise)
    en_safe = max(en, npdt(1e-10))
    q = npdt(alg.safety) * en_safe ** npdt(-beta1) * c.err_prev ** npdt(beta2)
    q = min(max(q, npdt(alg.qmin)), npdt(alg.qmax))
    if not finite:
        q = npdt(alg.qmin)
    dt_new = h * q if accept else h * min(q, npdt(1))

    # Explicit-stability cap: h·|λ| ≤ 2.5 with |λ| ≈ ‖Δ(du/dt)‖/‖Δu‖
    # from the step just taken (rosenbrock23 is L-stable: no cap).
    dt_cap = c.dt_cap
    if alg.method == "tsit5":
        nd, nf_ = npdt(host[3]), npdt(host[4])
        lam = nf_ / (npdt(1) if nd == 0 else nd)
        cap = npdt(2.5) / (npdt(1) if lam == 0 else lam)
        if not (lam > 0 and nd > 0 and np.isfinite(cap)):
            cap = npdt(np.inf)
        if accept:
            dt_cap = cap
        dt_new = min(dt_new, dt_cap)

    t_new = c.t + h if accept else c.t
    steady = accept and bool(host[2])
    out_of_time = accept and t_new >= tspan and not steady
    dead = dt_new < dt_min or (not finite and h <= dt_min)
    retcode = int(ReturnCode.Default)
    if steady:
        retcode = int(ReturnCode.Success)
    elif out_of_time:
        retcode = int(ReturnCode.MaxTime)
    elif dead:
        retcode = int(ReturnCode.Unstable)
    return c.replace(
        u=u_new if accept else c.u, fu=f_new if accept else c.fu, t=t_new,
        dt=dt_new, dt_cap=dt_cap, err_prev=en_safe if accept else c.err_prev,
        nsteps=c.nsteps + int(accept), attempts=c.attempts + 1,
        force_stop=steady or out_of_time or dead, retcode=retcode,
        stats=c.stats.incr(nsteps=int(accept), **counters))

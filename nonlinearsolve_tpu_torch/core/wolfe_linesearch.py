"""Wolfe-condition line searches, the ``LineSearchesJL`` family (the port of
``core/wolfe_linesearch.py``):

* ``StaticLineSearch`` — always the full step;
* ``StrongWolfe`` — bracket and zoom with cubic interpolation (Nocedal &
  Wright Alg. 3.5 / 3.6);
* ``HagerZhang`` — the CG_DESCENT search: approximate-Wolfe acceptance,
  ρ-expansion bracketing, secant steps with θ-bisection updates;
* ``MoreThuente`` — MINPACK's ``dcsrch`` / ``dcstep``.

The merit is φ(α) = ½‖F(u + α·du)‖², φ'(α) = ⟨F, J·du⟩: one
``torch.func.jvp`` per trial gives both, and one host read takes them.
The JAX package runs each search as one ``lax.while_loop`` with a mode
flag and ``jnp.where`` selects; here the same loop body runs on the host
in the working dtype, a conditional for each select, so the iterates, the
trials and the counts are the JAX package's.  A search fails
(``success=False``) when its cap runs out before its acceptance test
holds.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..utils.norms import tree_dot
from .autodiff import jvp


@dataclasses.dataclass(frozen=True)
class StaticLineSearch:
    """Always take ``alpha`` (LineSearches.Static)."""
    alpha: float = 1.0


@dataclasses.dataclass(frozen=True)
class StrongWolfe:
    c_1: float = 1e-4
    c_2: float = 0.9
    rho: float = 2.0          # bracket expansion factor
    alpha_0: float = 1.0
    alpha_max: float = 65536.0
    maxiters: int = 50


@dataclasses.dataclass(frozen=True)
class HagerZhang:
    delta: float = 0.1        # sufficient-decrease (Wolfe c1)
    sigma: float = 0.9        # curvature (Wolfe c2)
    epsilon: float = 1e-6     # approximate-Wolfe merit slack: ε·|φ(0)|
    theta: float = 0.5        # bisection weight in the interval update
    gamma: float = 0.66       # required interval shrink per refine round
    rho: float = 5.0          # bracket expansion factor
    alpha_0: float = 1.0
    alpha_max: float = 65536.0
    maxiters: int = 50


@dataclasses.dataclass(frozen=True)
class MoreThuente:
    f_tol: float = 1e-4       # sufficient decrease (ftol)
    gtol: float = 0.9         # curvature
    x_tol: float = 1e-8       # relative interval width termination
    alpha_0: float = 1.0
    alpha_min: float = 1e-16
    alpha_max: float = 65536.0
    maxiters: int = 100       # maxfev


_WOLFE_TYPES = (StaticLineSearch, StrongWolfe, HagerZhang, MoreThuente)

_LSJL_STRINGS = {
    "static": StaticLineSearch,
    "strongwolfe": StrongWolfe,
    "hagerzhang": HagerZhang,
    "morethuente": MoreThuente,
}


def LineSearchesJL(method: Any = None, **kwargs):
    """The reference's ``LineSearchesJL(; method)`` wrapper: the native
    config for the named method — a config instance (returned as it is), a
    config class, or a case-insensitive string ("static" | "backtracking" |
    "strongwolfe" | "hagerzhang" | "morethuente").  ``autodiff`` is
    accepted and ignored."""
    kwargs.pop("autodiff", None)
    if method is None:
        method = "static"
    if isinstance(method, str):
        key = method.lower().replace("_", "")
        if key == "backtracking":
            from .linesearch import BackTracking
            return BackTracking(**kwargs)
        if key not in _LSJL_STRINGS:
            raise ValueError(f"unknown LineSearchesJL method {method!r}")
        return _LSJL_STRINGS[key](**kwargs)
    if isinstance(method, type):
        return method(**kwargs)
    return method


def _phi_dphi(ctx, u, du, read):
    """``ev(α) -> (φ(α), φ'(α))`` as host scalars: one jvp and one read."""
    from .linesearch import at

    def ev(alpha):
        fu_a, jdu = jvp(ctx.f_flat, at(u, alpha, du), du)
        return tuple(read(0.5 * tree_dot(fu_a, fu_a), tree_dot(fu_a, jdu)))

    return ev


def _cubic_min(a, fa, dfa, b, fb, dfb):
    """The minimizer of the cubic through (a, fa, dfa), (b, fb, dfb)
    (Nocedal & Wright eq. 3.59); NaN on degenerate data."""
    d1 = dfa + dfb - 3.0 * (fa - fb) / (a - b)
    rad = d1 * d1 - dfa * dfb
    d2 = np.sqrt(np.maximum(rad, 0.0)) * np.sign(b - a)
    denom = dfb - dfa + 2.0 * d2
    x = b - (b - a) * (dfb + d2 - d1) / denom
    if rad < 0.0 or denom == 0.0 or not np.isfinite(x):
        return type(x)(np.nan)
    return x


def _strong_wolfe(cfg: StrongWolfe, ctx, u, du, read, npdt):
    """Bracket (mode 0), zoom (mode 1), done (mode 2); one trial an
    iteration."""
    ev = _phi_dphi(ctx, u, du, read)
    zero = npdt(0)
    phi0, dphi0 = ev(zero)
    c1, c2 = npdt(cfg.c_1), npdt(cfg.c_2)

    def armijo(a, p):
        return p <= phi0 + c1 * a * dphi0

    mode, a = 0, npdt(cfg.alpha_0)
    a_prev, phi_prev = zero, phi0
    a_lo, phi_lo, dphi_lo = zero, phi0, dphi0
    a_hi, phi_hi, dphi_hi = zero, phi0, dphi0
    a_star, phi_star, it, first = zero, phi0, 0, True
    while mode != 2 and it < cfg.maxiters:
        if mode == 0:
            trial = a
        else:
            # the zoom trial: the safeguarded cubic between lo and hi
            a_mid = 0.5 * (a_lo + a_hi)
            a_c = _cubic_min(a_lo, phi_lo, dphi_lo, a_hi, phi_hi, dphi_hi)
            lo_, hi_ = np.minimum(a_lo, a_hi), np.maximum(a_lo, a_hi)
            margin = 0.1 * (hi_ - lo_)
            ok_c = np.isfinite(a_c) and a_c > lo_ + margin and \
                a_c < hi_ - margin
            trial = a_c if ok_c else a_mid
        p, dp = ev(trial)
        curv_ok = abs(dp) <= -c2 * dphi0
        if mode == 0:
            # Alg. 3.5 in its order: Armijo violation → zoom; curvature →
            # accept; φ' ≥ 0 → reverse zoom; else expand
            to_zoom_hi = (not armijo(trial, p)) or (p >= phi_prev
                                                    and not first)
            accept_b = not to_zoom_hi and curv_ok
            to_zoom_rev = not to_zoom_hi and not curv_ok and dp >= 0.0
            dphi_prev = dphi0 if first else dphi_lo
            if to_zoom_hi:
                a_lo, phi_lo, dphi_lo = a_prev, phi_prev, dphi_prev
                a_hi, phi_hi, dphi_hi = trial, p, dp
            else:
                a_lo, phi_lo, dphi_lo = trial, p, dp
                a_hi, phi_hi, dphi_hi = a_prev, phi_prev, dphi_prev
            mode = 1 if (to_zoom_hi or to_zoom_rev) else (
                2 if accept_b else 0)
            if accept_b:
                a_star, phi_star = trial, p
            a = np.minimum(trial * npdt(cfg.rho), npdt(cfg.alpha_max))
            a_prev, phi_prev = trial, p
        else:
            # Alg. 3.6
            z_shrink_hi = (not armijo(trial, p)) or p >= phi_lo
            z_done = not z_shrink_hi and curv_ok
            z_flip = (not z_shrink_hi and not z_done
                      and dp * (a_hi - a_lo) >= 0.0)
            if z_shrink_hi:
                a_hi, phi_hi, dphi_hi = trial, p, dp
            else:
                if z_flip:
                    a_hi, phi_hi, dphi_hi = a_lo, phi_lo, dphi_lo
                a_lo, phi_lo, dphi_lo = trial, p, dp
            # a collapsed interval ends on lo (an Armijo point)
            tiny = abs(a_hi - a_lo) <= 1e-12 * np.maximum(1.0, a_hi)
            mode = 2 if (z_done or tiny) else 1
            a_star, phi_star = (trial, p) if z_done else (a_lo, phi_lo)
        it += 1
        first = False
    success = (mode == 2 and a_star > 0.0 and armijo(a_star, phi_star)
               and np.isfinite(phi_star))
    return a_star, bool(success), it + 1


def _hager_zhang(cfg: HagerZhang, ctx, u, du, read, npdt):
    """ρ-expansion bracket (mode 0), secant refinement with θ-bisection
    (mode 1), done (mode 2)."""
    ev = _phi_dphi(ctx, u, du, read)
    zero = npdt(0)
    phi0, dphi0 = ev(zero)
    eps_k = npdt(cfg.epsilon) * abs(phi0)
    delta, sigma, theta = npdt(cfg.delta), npdt(cfg.sigma), npdt(cfg.theta)
    one = npdt(1)

    def accept(a, p, dp):
        wolfe1 = (p - phi0) <= delta * a * dphi0
        wolfe2 = dp >= sigma * dphi0
        approx = (((npdt(2.0) * delta - one) * dphi0 >= dp) and wolfe2
                  and p <= phi0 + eps_k)
        return a > 0.0 and ((wolfe1 and wolfe2) or approx)

    def secant(a, b, da, db):
        return (a * db - b * da) / (one if db == da else db - da)

    big = npdt(cfg.alpha_max)
    mode, a, pa, da, b, db = 0, zero, phi0, dphi0, big, npdt(np.inf)
    trial, it = npdt(cfg.alpha_0), 0
    a_star, p_star, dp_star, width = zero, phi0, dphi0, big
    while mode != 2 and it < cfg.maxiters:
        p, dp = ev(trial)
        ok = accept(trial, p, dp)
        if mode == 0:
            # expand until φ' ≥ 0 or the merit is above its slack
            hi_found = dp >= 0.0 or p > phi0 + eps_k
            if hi_found:
                b, db = trial, dp
                # θ-bisection if the right end breaks the slack (HZ U3),
                # the secant otherwise
                nxt = ((one - theta) * a + theta * b if p > phi0 + eps_k
                       else secant(a, b, da, db))
            else:
                a, pa, da = trial, p, dp
                nxt = np.minimum(trial * npdt(cfg.rho), big)
            new_mode = 1 if hi_found else 0
        else:
            # the interval update (HZ U1–U3) and the next secant
            inside = a < trial < b
            lo_ok = p <= phi0 + eps_k
            if inside and dp < 0.0 and lo_ok:
                a, pa, da = trial, p, dp
            elif inside and (dp >= 0.0 or (not lo_ok and dp < 0.0)):
                b, db = trial, dp
            new_width = b - a
            # γ-forced bisection when the interval fails to shrink enough
            sec = secant(a, b, da, db)
            use_bisect = (not np.isfinite(sec) or sec <= a or sec >= b
                          or new_width > npdt(cfg.gamma) * width)
            nxt = 0.5 * (a + b) if use_bisect else sec
            new_mode = 2 if new_width <= 1e-12 * np.maximum(1.0, b) else 1
            width = new_width
        # the returned point: the accepting trial, else the current left
        # end, so that a capped search still returns a usable step
        if ok:
            a_star, p_star, dp_star = trial, p, dp
        else:
            a_star, p_star, dp_star = a, pa, da
        mode = 2 if ok else new_mode
        trial = nxt
        it += 1
    success = mode == 2 and accept(a_star, p_star, dp_star) and \
        np.isfinite(p_star)
    return a_star, bool(success), it + 1


def _dcstep(stx, fx, dx, sty, fy, dy, stp, fp, dp, brackt, stpmin, stpmax):
    """MINPACK ``dcstep``'s four-case safeguarded step; returns the new
    (stx, fx, dx, sty, fy, dy, stp, brackt).  Every case's formula is
    evaluated, as in the JAX package, and the case selects."""
    T = type(stp)
    sgnd = dp * np.sign(dx)

    def nz(x):
        return T(1) if x == 0.0 else x

    def theta_gamma(case):
        theta = 3.0 * (fx - fp) / (stp - stx) + dx + dp
        s = nz(np.maximum(abs(theta), np.maximum(abs(dx), abs(dp))))
        gamma_sq = (theta / s) * (theta / s) - (dx / s) * (dp / s)
        gamma = s * np.sqrt(np.maximum(gamma_sq, 0.0))
        if case != 4 and stp < stx:
            gamma = -gamma
        return theta, gamma

    # case 1: fp > fx — cubic vs quadratic (function values), bracketing
    theta1, gamma1 = theta_gamma(1)
    r1 = ((gamma1 - dx) + theta1) / nz(((gamma1 - dx) + gamma1) + dp)
    stpc1 = stx + r1 * (stp - stx)
    stpq1 = stx + ((dx / ((fx - fp) / (stp - stx) + dx)) / 2.0) * (stp - stx)
    stpf1 = (stpc1 if abs(stpc1 - stx) < abs(stpq1 - stx)
             else stpc1 + (stpq1 - stpc1) / 2.0)

    # case 2: fp ≤ fx, sgnd < 0 — cubic vs secant, bracketing
    theta2, gamma2 = theta_gamma(2)
    r2 = ((gamma2 - dp) + theta2) / nz(((gamma2 - dp) + gamma2) + dx)
    stpc2 = stp + r2 * (stx - stp)
    stpq2 = stp + (dp / (dp - dx)) * (stx - stp)
    stpf2 = stpc2 if abs(stpc2 - stp) > abs(stpq2 - stp) else stpq2

    # case 3: fp ≤ fx, same sign, |dp| < |dx| — extrapolation, clipped
    theta3 = 3.0 * (fx - fp) / (stp - stx) + dx + dp
    s3 = nz(np.maximum(abs(theta3), np.maximum(abs(dx), abs(dp))))
    g3sq = np.maximum((theta3 / s3) * (theta3 / s3) - (dx / s3) * (dp / s3),
                      0.0)
    gamma3 = s3 * np.sqrt(g3sq)
    if stp > stx:
        gamma3 = -gamma3
    r3 = ((gamma3 - dp) + theta3) / nz((gamma3 + (dx - dp)) + gamma3)
    stpc3_raw = stp + r3 * (stx - stp)
    if r3 < 0.0 and gamma3 != 0.0:
        stpc3 = stpc3_raw
    else:
        stpc3 = stpmax if stp > stx else stpmin
    stpq3 = stp + (dp / (dp - dx)) * (stx - stp)
    stpf3_br = stpc3 if abs(stpc3 - stp) < abs(stpq3 - stp) else stpq3
    stpf3_nbr = stpc3 if abs(stpc3 - stp) > abs(stpq3 - stp) else stpq3
    # stay within 2/3 of the way to the far end when bracketed
    lim = stp + 0.66 * (sty - stp)
    stpf3_br = (np.minimum(lim, stpf3_br) if stp > stx
                else np.maximum(lim, stpf3_br))
    stpf3 = (stpf3_br if brackt
             else np.minimum(np.maximum(stpf3_nbr, stpmin), stpmax))

    # case 4: |dp| ≥ |dx| — the cubic over [stp, sty] if bracketed, else
    # the bound
    theta4 = 3.0 * (fp - fy) / (sty - stp) + dy + dp
    s4 = nz(np.maximum(abs(theta4), np.maximum(abs(dy), abs(dp))))
    g4sq = np.maximum((theta4 / s4) * (theta4 / s4) - (dy / s4) * (dp / s4),
                      0.0)
    gamma4 = s4 * np.sqrt(g4sq)
    if stp > sty:
        gamma4 = -gamma4
    r4 = ((gamma4 - dp) + theta4) / nz(((gamma4 - dp) + gamma4) + dy)
    stpc4 = stp + r4 * (sty - stp)
    stpf4 = stpc4 if brackt else (stpmax if stp > stx else stpmin)

    case1 = fp > fx
    case2 = not case1 and sgnd < 0.0
    case3 = not case1 and not case2 and abs(dp) < abs(dx)
    stpf = (stpf1 if case1 else stpf2 if case2 else stpf3 if case3
            else stpf4)
    brackt_n = brackt or case1 or case2

    # the interval update
    if case1:
        sty_n, fy_n, dy_n = stp, fp, dp
    elif sgnd < 0.0:
        sty_n, fy_n, dy_n = stx, fx, dx
    else:
        sty_n, fy_n, dy_n = sty, fy, dy
    if case1:
        stx_n, fx_n, dx_n = stx, fx, dx
    else:                    # cases 2–4: the trial becomes the best point
        stx_n, fx_n, dx_n = stp, fp, dp
    stpf = np.minimum(np.maximum(stpf, stpmin), stpmax)
    return stx_n, fx_n, dx_n, sty_n, fy_n, dy_n, T(stpf), brackt_n


def _more_thuente(cfg: MoreThuente, ctx, u, du, read, npdt):
    ev = _phi_dphi(ctx, u, du, read)
    zero = npdt(0)
    phi0, dphi0 = ev(zero)
    gtest = npdt(cfg.f_tol) * dphi0
    xtrapl, xtrapu = npdt(1.1), npdt(4.0)
    amin, amax = npdt(cfg.alpha_min), npdt(cfg.alpha_max)
    gtol = npdt(cfg.gtol)

    width0 = npdt(cfg.alpha_max - cfg.alpha_min)
    stage, stx, fx, dx, sty, fy, dy = 1, zero, phi0, dphi0, zero, phi0, dphi0
    stp, brackt = npdt(cfg.alpha_0), False
    width, width1 = width0, npdt(2.0) * width0
    stmin, stmax = zero, npdt(cfg.alpha_0 * (1.0 + 4.0))
    done, success, it = False, False, 0
    while not done and it < cfg.maxiters:
        fp, dp = ev(stp)
        ftest = phi0 + stp * gtest
        # dcsrch's convergence and termination tests
        conv = fp <= ftest and abs(dp) <= gtol * (-dphi0)
        warn_round = brackt and (stp <= stmin or stp >= stmax)
        warn_xtol = brackt and (stmax - stmin) <= npdt(cfg.x_tol) * stmax
        warn_max = stp == amax and fp <= ftest and dp <= gtest
        warn_min = stp == amin and (fp > ftest or dp >= gtest)
        new_done = (conv or warn_round or warn_xtol or warn_max or warn_min
                    or not np.isfinite(fp))
        # a WARN exit counts as success only with sufficient decrease;
        # running out of maxiters without one is a failure, and so is a
        # stall at alpha_min
        new_success = conv or ((warn_round or warn_xtol or warn_max)
                               and fp <= ftest and np.isfinite(fp)
                               and stp > 0.0)
        # the stage switch: ψ(stp) ≤ 0 and φ'(stp) ≥ 0 → stage 2
        if (stage == 1 and fp <= ftest
                and dp >= np.minimum(npdt(cfg.f_tol), gtol) * dphi0):
            stage = 2
        # the modified function in stage 1 while above the ψ line
        use_mod = stage == 1 and fp <= fx and fp > ftest
        if use_mod:
            fm, fxm, fym = fp - stp * gtest, fx - stx * gtest, fy - sty * gtest
            dm, dxm, dym = dp - gtest, dx - gtest, dy - gtest
        else:
            fm, fxm, fym, dm, dxm, dym = fp, fx, fy, dp, dx, dy
        (stxm, fxm, dxm, stym, fym, dym, stp_n, brackt_n) = _dcstep(
            stx, fxm, dxm, sty, fym, dym, stp, fm, dm, brackt, stmin, stmax)
        if use_mod:
            fx_n, fy_n = fxm + stxm * gtest, fym + stym * gtest
            dx_n, dy_n = dxm + gtest, dym + gtest
        else:
            fx_n, fy_n, dx_n, dy_n = fxm, fym, dxm, dym
        # forced bisection when the bracket shrinks too slowly
        if brackt_n and abs(stym - stxm) >= 0.66 * width1:
            stp_n = stxm + 0.5 * (stym - stxm)
        width1_n = width if brackt_n else width1
        width_n = abs(stym - stxm) if brackt_n else width
        if brackt_n:
            stmin_n = np.minimum(stxm, stym)
            stmax_n = np.maximum(stxm, stym)
        else:
            stmin_n = stp_n + xtrapl * (stp_n - stxm)
            stmax_n = stp_n + xtrapu * (stp_n - stxm)
        stp_n = np.minimum(np.maximum(stp_n, amin), amax)
        # a degenerate bracket: park at the best point, stop next round
        if brackt_n and (stp_n <= stmin_n or stp_n >= stmax_n):
            stp_n = stxm
        stp = stp if new_done else stp_n
        stx, fx, dx, sty, fy, dy = stxm, fx_n, dx_n, stym, fy_n, dy_n
        brackt, width, width1 = brackt_n, width_n, width1_n
        stmin, stmax = stmin_n, stmax_n
        done, success = new_done, new_success
        it += 1
    return stp, bool(success), it + 1


def wolfe_ls_solve(cfg, ctx, u, du, fu, read, npdt):
    """Dispatch from ``core.linesearch.ls_solve``."""
    from .linesearch import LSResult, at
    if isinstance(cfg, StaticLineSearch):
        alpha = npdt(cfg.alpha)
        ok, = read(torch.isfinite(ctx.f_flat(at(u, alpha, du))).all())
        return LSResult(alpha=alpha, success=bool(ok), state=None, nf=1)
    if isinstance(cfg, StrongWolfe):
        a, ok, nf = _strong_wolfe(cfg, ctx, u, du, read, npdt)
    elif isinstance(cfg, HagerZhang):
        a, ok, nf = _hager_zhang(cfg, ctx, u, du, read, npdt)
    elif isinstance(cfg, MoreThuente):
        a, ok, nf = _more_thuente(cfg, ctx, u, du, read, npdt)
    else:  # pragma: no cover
        raise ValueError(f"unknown Wolfe linesearch {cfg!r}")
    return LSResult(alpha=a, success=ok, state=None, nf=nf)

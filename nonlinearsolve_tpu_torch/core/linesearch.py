"""Line-search globalization (the port of ``core/linesearch.py``):

* ``BackTracking`` — Armijo backtracking with quadratic interpolation
  (c₁ = 1e-4, ρ ∈ [0.1, 0.5]);
* ``LiFukushimaLineSearch`` — the derivative-free search of Li & Fukushima
  (2000), a strong full-step test, then backtracking under the relaxed
  nonmonotone condition;
* ``RobustNonMonotoneLineSearch`` — the DF-SANE search (La Cruz, Martínez
  & Raydan 2006) over an M-history of merit values.

The JAX package's ``lax.while_loop``s become host loops: each trial
evaluates ``f`` on the device and reads the scalars it needs in one host
sync (``read``, by default ``_backend.fetch``; the engine passes its
``PendingReads.read`` so the step's own flags ride on the first trial's
read).  The step arithmetic runs on the host in the working dtype.
Protocol: ``ls_init_reads`` / ``ls_init(cfg, fu, host)``;
``ls_solve(cfg, state, ctx, u, du, fu, J, nsteps, read) -> LSResult``;
``ls_post_step(cfg, state, fu_new_norm)`` (the host ‖fu_new‖).

The simple tier's batched searches (``li_fukushima_batched``,
``robust_nonmonotone_batched``) keep each row's step, state and count on
the device and read one flag a trial.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .. import _backend
from .autodiff import jvp
from ..ops.operators import mv
from .lockstep import any_row
from ..utils.norms import l2_norm, tree_dot
from .descent import DescentCtx


@dataclasses.dataclass(frozen=True)
class BackTracking:
    c_1: float = 1e-4
    rho_hi: float = 0.5
    rho_lo: float = 0.1
    initial_alpha: float = 1.0
    maxiters: int = 100


@dataclasses.dataclass(frozen=True)
class LiFukushimaLineSearch:
    lambda_0: float = 1.0
    beta: float = 0.5
    sigma_1: float = 1e-3
    sigma_2: float = 1e-3
    eta: float = 0.1
    rho: float = 0.9
    nan_maxiters: int = 5
    maxiters: int = 100


@dataclasses.dataclass(frozen=True)
class RobustNonMonotoneLineSearch:
    gamma: float = 1e-4
    sigma_1: float = 1.0
    M: int = 10
    tau_min: float = 0.1
    tau_max: float = 0.5
    n_exp: int = 2
    maxiters: int = 100


@dataclasses.dataclass(frozen=True)
class LSResult:
    alpha: Any          # host scalar of the working dtype
    success: bool
    state: Any
    nf: int


@dataclasses.dataclass(frozen=True)
class RNMLSState:
    history: Any       # (M,) host ring of merit values
    f_1: Any           # merit of the initial iterate
    nsteps: int        # outer steps seen


def ipow(x, n: int):
    """``x ** n`` for an integer ``n ≥ 1`` by square-and-multiply, as
    ``lax.integer_pow`` evaluates it (host scalars or tensors)."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def at(u, alpha, du):
    """``u + α·du`` with one rounding per element (the fused multiply-add
    XLA makes of the JAX package's expression)."""
    return torch.add(u, du, alpha=float(alpha))


def _merit(fu):
    return 0.5 * tree_dot(fu, fu)


def ls_init_reads(cfg, fu) -> list:
    if isinstance(cfg, RobustNonMonotoneLineSearch):
        return [l2_norm(fu)]
    return []


def ls_init(cfg, fu, host):
    if isinstance(cfg, RobustNonMonotoneLineSearch):
        merit = ipow(host[0], cfg.n_exp)
        return RNMLSState(history=np.full(cfg.M, merit), f_1=merit, nsteps=0)
    return None


def ls_solve(cfg, state, ctx: DescentCtx, u, du, fu, J, nsteps,
             read=_backend.fetch) -> LSResult:
    npdt = _backend.real_np_dtype(u.dtype)
    with np.errstate(all="ignore"):
        if isinstance(cfg, BackTracking):
            return _backtracking(cfg, ctx, u, du, fu, J, read, npdt)
        if isinstance(cfg, LiFukushimaLineSearch):
            return _li_fukushima(cfg, state, ctx, u, du, fu, nsteps, read,
                                 npdt)
        if isinstance(cfg, RobustNonMonotoneLineSearch):
            return _robust_nonmonotone(cfg, state, ctx, u, du, fu, read,
                                       npdt)
        from .wolfe_linesearch import _WOLFE_TYPES, wolfe_ls_solve
        if isinstance(cfg, _WOLFE_TYPES):
            return wolfe_ls_solve(cfg, ctx, u, du, fu, read, npdt)
    raise ValueError(f"unknown linesearch {cfg!r}")


def _clip(x, lo, hi):
    """``jnp.clip``: NaN in, NaN out."""
    return np.minimum(np.maximum(x, lo), hi)


def _backtracking(cfg: BackTracking, ctx: DescentCtx, u, du, fu, J, read,
                  npdt) -> LSResult:
    if J is not None:
        slope_t = tree_dot(fu, mv(J, du))
    else:
        slope_t = tree_dot(fu, jvp(ctx.f_flat, u, du)[1])
    alpha = npdt(cfg.initial_alpha)
    phi0, slope, phival = read(_merit(fu), slope_t,
                               _merit(ctx.f_flat(at(u, alpha, du))))
    c_1, rho_lo, rho_hi = npdt(cfg.c_1), npdt(cfg.rho_lo), npdt(cfg.rho_hi)

    def armijo(alpha, phival):
        return phival <= phi0 + c_1 * alpha * slope

    it = 0
    while it < cfg.maxiters:
        it += 1
        if armijo(alpha, phival):
            break
        # the quadratic interpolation minimizer, clipped to [ρ_lo, ρ_hi]·α
        denom = npdt(2.0) * (phival - phi0 - alpha * slope)
        alpha_q = -slope * alpha * alpha / (denom if denom != 0 else npdt(1))
        alpha_new = _clip(alpha_q, rho_lo * alpha, rho_hi * alpha)
        if not np.isfinite(alpha_new):
            alpha_new = rho_hi * alpha
        alpha = alpha_new
        phival, = read(_merit(ctx.f_flat(at(u, alpha, du))))
    # success needs the Armijo condition to hold: exhausting maxiters is a
    # line-search failure
    success = bool(armijo(alpha, phival) and np.isfinite(alpha)
                   and np.isfinite(phival))
    return LSResult(alpha=alpha, success=success, state=None, nf=it + 1)


def _li_fukushima(cfg: LiFukushimaLineSearch, state, ctx: DescentCtx, u, du,
                  fu, nsteps, read, npdt) -> LSResult:
    """The strong test ‖F(x+λd)‖ ≤ ρ‖F(x)‖ − σ₂λ²‖d‖² accepts the
    (NaN-guarded) full step; otherwise backtrack under ‖F(x+λd)‖ ≤
    (1+η_k)‖F(x)‖ − σ₁λ²‖d‖² with η_k = η/(k+1)².  Exhausting maxiters (or
    the NaN guard) is a failure."""
    k = npdt(nsteps)
    eta_k = npdt(cfg.eta) / ((k + npdt(1.0)) * (k + npdt(1.0)))
    beta = npdt(cfg.beta)

    def probe(lam):
        f = ctx.f_flat(at(u, lam, du))
        return [torch.isfinite(f).all(), l2_norm(f)]

    lam0 = npdt(cfg.lambda_0)
    fu_norm, d_norm2, finite, f_full = read(l2_norm(fu), tree_dot(du, du),
                                            *probe(lam0))
    # the NaN guard: shrink λ until f(u + λd) is finite
    nan_iters = 0
    while not finite and nan_iters < cfg.nan_maxiters:
        lam0 = lam0 * beta
        nan_iters += 1
        finite, f_full = read(*probe(lam0))
    nan_ok = bool(finite)
    full_ok = bool(f_full <= npdt(cfg.rho) * fu_norm
                   - npdt(cfg.sigma_2) * lam0 * lam0 * d_norm2)
    lam, it, bt_ok = lam0, 0, False
    if not full_ok:
        lam = lam0 * beta
        while not bt_ok and it < cfg.maxiters:
            fnew, = read(l2_norm(ctx.f_flat(at(u, lam, du))))
            bt_ok = bool(fnew <= (npdt(1.0) + eta_k) * fu_norm
                         - npdt(cfg.sigma_1) * lam * lam * d_norm2)
            if not bt_ok:
                lam = lam * beta
            it += 1
    return LSResult(alpha=lam, success=nan_ok and (full_ok or bt_ok),
                    state=state, nf=it + nan_iters + 2)


def _robust_nonmonotone(cfg: RobustNonMonotoneLineSearch, state: RNMLSState,
                        ctx: DescentCtx, u, du, fu, read, npdt) -> LSResult:
    """The DF-SANE line search (la2006spectral, Alg. 1 step 3)."""
    f_bar = state.history.max()
    n = state.nsteps + 1
    eta = state.f_1 / ipow(npdt(n), 2)
    gamma = npdt(cfg.gamma)
    tau_min, tau_max = npdt(cfg.tau_min), npdt(cfg.tau_max)

    def merit_at(alpha):
        return ipow(l2_norm(ctx.f_flat(at(u, alpha, du))), cfg.n_exp)

    ap = am = npdt(cfg.sigma_1)
    it, found, alpha = 0, False, npdt(0)
    f_cur = None
    while not found and it < cfg.maxiters:
        wanted = [merit_at(ap), merit_at(-am)]
        if f_cur is None:
            f_cur, fp, fm = read(ipow(l2_norm(fu), cfg.n_exp), *wanted)
        else:
            fp, fm = read(*wanted)
        ok_p = fp <= f_bar + eta - gamma * ap * ap * f_cur
        ok_m = fm <= f_bar + eta - gamma * am * am * f_cur
        alpha = ap if ok_p else -am
        found = bool(ok_p or ok_m)
        it += 1
        if not found:
            # the quadratic-interpolation update, clipped to [τ_min, τ_max]·α
            two = npdt(2.0)
            ap_new = _clip(ap * ap * f_cur / (fp + (two * ap - 1) * f_cur),
                           tau_min * ap, tau_max * ap)
            am_new = _clip(am * am * f_cur / (fm + (two * am - 1) * f_cur),
                           tau_min * am, tau_max * am)
            ap = ap_new if np.isfinite(ap_new) else tau_min * ap
            am = am_new if np.isfinite(am_new) else tau_min * am
    return LSResult(alpha=alpha, success=found, state=state, nf=2 * it)


def ls_post_reads(cfg, fu_new) -> list:
    """The device scalar ``ls_post_step`` needs: ‖fu_new‖ (DF-SANE's
    history)."""
    if isinstance(cfg, RobustNonMonotoneLineSearch):
        return [l2_norm(fu_new)]
    return []


def ls_post_step(cfg, state, host):
    """Push the accepted iterate's merit into the nonmonotone history ring
    (``host``: the values of ``ls_post_reads``)."""
    if isinstance(cfg, RobustNonMonotoneLineSearch) and state is not None:
        nsteps = state.nsteps + 1
        history = state.history.copy()
        history[(nsteps - 1) % cfg.M] = ipow(host[0], cfg.n_exp)
        return dataclasses.replace(state, history=history, nsteps=nsteps)
    return state


# ---------------------------------------------------------------------------
# batched searches (the simple tier): one row a trajectory
# ---------------------------------------------------------------------------
#
# ``res(X)`` evaluates the residual of every row.  Each row has its own
# step and its own count of evaluations; the trial loop runs while any
# row still searches, and reads one flag a trial (is any row still
# searching?).  A row that has finished, or whose outer solve has stopped
# (``active`` False), takes no more trials and counts none: the JAX
# package's inner ``while_loop`` under ``vmap`` computes them and discards
# them, with the same per-row results.


def _rows_l2(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _rows_at(u, alpha, du):
    """``u + α·du`` per row with one rounding per element."""
    return torch.addcmul(u, alpha[:, None], du)


def li_fukushima_batched(cfg: LiFukushimaLineSearch, res, u, du, fu,
                         nsteps, active):
    """``_li_fukushima`` on every row: returns ``(alpha, success, nf)``,
    (B,) tensors.  ``nsteps``: each row's outer step count."""
    dtype = u.dtype
    fu_norm = _rows_l2(fu)
    d_norm2 = (du * du).sum(-1)
    k1 = nsteps.to(dtype) + 1.0
    eta_k = cfg.eta / (k1 * k1)
    beta = cfg.beta

    def probe(lam):
        f = res(_rows_at(u, lam, du))
        return torch.isfinite(f).all(-1), _rows_l2(f)

    lam0 = torch.full_like(fu_norm, cfg.lambda_0)
    finite, f_full = probe(lam0)
    nan_iters = torch.zeros_like(nsteps)
    # the NaN guard: shrink λ until f(u + λd) is finite
    while True:
        want = ~finite & (nan_iters < cfg.nan_maxiters) & active
        if not any_row(want):
            break
        lam0 = torch.where(want, lam0 * beta, lam0)
        nan_iters = nan_iters + want.to(nan_iters.dtype)
        fin, ff = probe(lam0)
        finite = torch.where(want, fin, finite)
        f_full = torch.where(want, ff, f_full)
    full_ok = f_full <= cfg.rho * fu_norm - cfg.sigma_2 * lam0 * lam0 \
        * d_norm2
    lam = lam0 * beta
    it = torch.zeros_like(nsteps)
    done = torch.zeros_like(full_ok)
    searching = ~full_ok & active
    while True:
        want = searching & ~done & (it < cfg.maxiters)
        if not any_row(want):
            break
        fnew = _rows_l2(res(_rows_at(u, lam, du)))
        ok = fnew <= (1.0 + eta_k) * fu_norm \
            - cfg.sigma_1 * lam * lam * d_norm2
        lam = torch.where(want & ~ok, lam * beta, lam)
        it = it + want.to(it.dtype)
        done = done | (want & ok)
    lam = torch.where(full_ok, lam0, lam)
    it = torch.where(full_ok, torch.zeros_like(it), it)
    success = finite & (full_ok | done)
    return lam, success, it + nan_iters + 2


@dataclasses.dataclass(frozen=True)
class BatchRNMLSState:
    """``RNMLSState`` with one row a trajectory: ``history`` (B, M),
    ``f_1`` and ``nsteps`` (B,)."""

    history: torch.Tensor
    f_1: torch.Tensor
    nsteps: torch.Tensor


def rnm_init_batched(cfg: RobustNonMonotoneLineSearch, fu):
    merit = ipow(_rows_l2(fu), cfg.n_exp)
    return BatchRNMLSState(
        history=merit[:, None].repeat(1, cfg.M), f_1=merit,
        nsteps=torch.zeros(fu.shape[0], dtype=torch.int32,
                           device=fu.device))


def rnm_post_step_batched(cfg: RobustNonMonotoneLineSearch,
                          state: BatchRNMLSState, fu_new):
    """Push each row's accepted merit into its history ring."""
    nsteps = state.nsteps + 1
    slot = torch.remainder(nsteps - 1, cfg.M).long()[:, None]
    merit = ipow(_rows_l2(fu_new), cfg.n_exp)
    return BatchRNMLSState(
        history=state.history.scatter(1, slot, merit[:, None]),
        f_1=state.f_1, nsteps=nsteps)


def robust_nonmonotone_batched(cfg: RobustNonMonotoneLineSearch,
                               state: BatchRNMLSState, res, u, du, fu,
                               active):
    """``_robust_nonmonotone`` on every row: returns ``(alpha, success,
    nf)``, (B,) tensors."""
    f_cur = ipow(_rows_l2(fu), cfg.n_exp)
    f_bar = state.history.amax(-1)
    eta = state.f_1 / ipow((state.nsteps + 1).to(f_cur.dtype), 2)
    gamma = cfg.gamma

    def merit_at(alpha):
        return ipow(_rows_l2(res(_rows_at(u, alpha, du))), cfg.n_exp)

    def shrink(a, fa):
        new = a * a * f_cur / (fa + (2.0 * a - 1.0) * f_cur)
        new = torch.minimum(torch.maximum(new, cfg.tau_min * a),
                            cfg.tau_max * a)
        return torch.where(torch.isfinite(new), new, cfg.tau_min * a)

    ap = torch.full_like(f_cur, cfg.sigma_1)
    am = ap.clone()
    alpha = torch.zeros_like(f_cur)
    it = torch.zeros_like(state.nsteps)
    found = torch.zeros_like(active)
    while True:
        want = ~found & (it < cfg.maxiters) & active
        if not any_row(want):
            break
        fp, fm = merit_at(ap), merit_at(-am)
        ok_p = fp <= f_bar + eta - gamma * ap * ap * f_cur
        ok_m = fm <= f_bar + eta - gamma * am * am * f_cur
        hit = ok_p | ok_m
        alpha = torch.where(want, torch.where(ok_p, ap, -am), alpha)
        ap = torch.where(want & ~hit, shrink(ap, fp), ap)
        am = torch.where(want & ~hit, shrink(am, fm), am)
        it = it + want.to(it.dtype)
        found = found | (want & hit)
    return alpha, found, 2 * it

"""Trust-region globalization (the port of ``core/trust_region.py``):

* ``GenericTrustRegionScheme`` with the seven radius-update schemes
  Simple / NLsolve / NocedalWright / Hei / Yuan / Fan / Bastin, their
  default thresholds and parameters p1–p4;
* ``LevenbergMarquardtTrustRegion`` — the Transtrum–Sethna b_uphill accept
  rule, with ``loss_old`` updated on acceptance (as in the JAX package).

A trust-region step is split at its host read.  ``tr_candidate`` does the
device work — the candidate ``u + δu``, ``f`` there, and the 0-d tensors
the decision needs (the norms and inner products of the ratio ρ, the
schemes' extra products at the candidate) — without reading anything;
the engine reads those with the rest of its step, and ``tr_update``
decides on the host in the working dtype: accept or not, the new radius.
The state's scalars are host scalars; the LM trust region's cached
velocity is a device tensor.  ``tr_init_reads`` / ``tr_init`` split the
initialisation the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from .._backend import np_dtype, real_np_dtype
from .autodiff import jvp
from ..ops.operators import mv, rmv_t, transpose_apply
from ..utils import ordering
from ..utils.norms import l2_norm, tree_dot
from .descent import DescentCtx, DescentResult

SCHEMES = ("simple", "nlsolve", "nocedalwright", "hei", "yuan", "fan",
           "bastin")


class RadiusUpdateSchemes:
    """Named radius-update schemes (the reference's ``RadiusUpdateSchemes``)
    — pass one as ``TrustRegion(radius_update_scheme=
    RadiusUpdateSchemes.Fan)``."""

    Simple = "simple"
    NLsolve = "nlsolve"
    NocedalWright = "nocedalwright"
    Hei = "hei"
    Yuan = "yuan"
    Fan = "fan"
    Bastin = "bastin"


@dataclasses.dataclass(frozen=True)
class GenericTrustRegionScheme:
    method: str = "simple"
    step_threshold: Optional[float] = None
    shrink_threshold: Optional[float] = None
    expand_threshold: Optional[float] = None
    shrink_factor: Optional[float] = None
    expand_factor: Optional[float] = None
    max_trust_radius: Optional[float] = None
    initial_trust_radius: Optional[float] = None

    def __post_init__(self):
        if self.method not in SCHEMES:
            raise ValueError(f"unknown radius update scheme {self.method!r}")

    # the per-scheme default thresholds
    def resolved_step_threshold(self) -> float:
        if self.step_threshold is not None:
            return self.step_threshold
        return {"hei": 0.0, "yuan": 1e-3, "bastin": 1 / 20}.get(
            self.method, 1e-4)

    def resolved_shrink_threshold(self) -> float:
        if self.shrink_threshold is not None:
            return self.shrink_threshold
        return {"hei": 0.0, "nlsolve": 1 / 20, "bastin": 1 / 20}.get(
            self.method, 0.25)

    def resolved_expand_threshold(self) -> float:
        if self.expand_threshold is not None:
            return self.expand_threshold
        return {"nlsolve": 0.9, "hei": 0.0, "bastin": 0.9}.get(
            self.method, 0.75)

    def resolved_shrink_factor(self) -> float:
        if self.shrink_factor is not None:
            return self.shrink_factor
        return {"nlsolve": 0.5, "hei": 0.0, "bastin": 1 / 20}.get(
            self.method, 0.25)

    def resolved_expand_factor(self) -> float:
        return 2.0 if self.expand_factor is None else self.expand_factor

    def parameters(self) -> tuple:
        """p1–p4."""
        return {
            "nlsolve": (0.5, 0.0, 0.0, 0.0),
            "hei": (5.0, 0.1, 0.15, 0.15),
            "yuan": (2.0, 1 / 6, 6.0, 0.0),
            "fan": (0.1, 0.25, 12.0, 1.0e18),
            "bastin": (2.5, 0.25, 0.0, 0.0),
        }.get(self.method, (0.0, 0.0, 0.0, 0.0))


@dataclasses.dataclass(frozen=True)
class LevenbergMarquardtTrustRegion:
    b_uphill: float = 1.0


@dataclasses.dataclass(frozen=True)
class TRState:
    trust_region: Any            # host scalars of the working dtype
    max_trust_radius: Any
    p1: Any
    p2: Any
    p3: Any
    p4: Any
    shrink_counter: int
    last_step_accepted: bool


@dataclasses.dataclass(frozen=True)
class LMTRState:
    loss_old: Any                # host scalar
    v_cache: Any                 # device tensor
    norm_v_old: Any              # host scalar
    last_step_accepted: bool


def _vjp_at(ctx: DescentCtx, u, v):
    """Jᵀv at ``u``, unconjugated on a complex state (the JAX package's
    VJP; torch's gives Jᴴv)."""
    vjp_fn = torch.func.vjp(ctx.f_flat, u)[1]
    return transpose_apply(lambda w: vjp_fn(w)[0], v)


def tr_init_reads(cfg, ctx: DescentCtx, fu, u) -> list:
    """The device scalars ``tr_init`` needs: ‖u‖, ‖fu‖, max u, min u and
    (Yuan) ‖Jᵀfu‖ at u0."""
    if isinstance(cfg, LevenbergMarquardtTrustRegion):
        return []
    out = [l2_norm(u), l2_norm(fu), ordering.amax(u), ordering.amin(u)]
    if cfg.method == "yuan":
        out.append(l2_norm(_vjp_at(ctx, u, fu)))
    return out


def tr_init(cfg, u, host) -> Any:
    """The initial state from the host values of ``tr_init_reads``.  Its
    scalars have the state's dtype, as in the JAX package: complex on a
    complex state (numpy orders complex scalars as JAX does), where
    max(u) − min(u) can give the radius an imaginary part."""
    npdt = np_dtype(u.dtype)
    if isinstance(cfg, LevenbergMarquardtTrustRegion):
        return LMTRState(loss_old=npdt(np.inf), v_cache=u,
                         norm_v_old=npdt(np.inf), last_step_accepted=False)
    rdt = real_np_dtype(u.dtype)
    u0_norm, fu_norm, umax, umin = host[:4]
    with np.errstate(all="ignore"):
        # max_trust_radius: Inf except Simple / NocedalWright →
        # max(‖fu‖, max(u) - min(u))
        if cfg.max_trust_radius is not None:
            mtr = npdt(cfg.max_trust_radius)
        elif cfg.method in ("simple", "nocedalwright"):
            mtr = np.maximum(fu_norm, umax - umin)
        else:
            mtr = npdt(np.inf)
        p1, p2, p3, p4 = (npdt(p) for p in cfg.parameters())
        if cfg.initial_trust_radius is not None:
            itr = npdt(cfg.initial_trust_radius)
        elif cfg.method == "nlsolve":
            itr = u0_norm if u0_norm > 0 else rdt(1)
        elif cfg.method in ("hei", "bastin"):
            itr = npdt(1)
        elif cfg.method == "fan":
            itr = (fu_norm ** rdt(0.99)) / rdt(10.0)
        else:
            itr = mtr / rdt(11.0)
        if cfg.method == "yuan":
            # Yuan always starts from p1·‖Jᵀfu‖ at u0, a given initial
            # radius included (as the reference does)
            itr = p1 * host[4]
    return TRState(trust_region=npdt(itr), max_trust_radius=npdt(mtr),
                   p1=p1, p2=p2, p3=p3, p4=p4, shrink_counter=0,
                   last_step_accepted=False)


def tr_candidate(cfg, state, ctx: DescentCtx, J, fu, u, du,
                 descent_result: DescentResult):
    """The device half of a trust-region step: returns ``(u_new, fu_new,
    reads)`` with ``reads`` the 0-d tensors ``tr_update`` needs."""
    u_new = u + du
    fu_new = ctx.f_flat(u_new)
    if isinstance(cfg, LevenbergMarquardtTrustRegion):
        v = descent_result.v if descent_result.v is not None else du
        return u_new, fu_new, [l2_norm(v), tree_dot(v, state.v_cache),
                               l2_norm(fu_new)]
    # ρ = (‖fu_new‖² - ‖fu‖²)/2 / (⟨δu, Jᵀfu⟩ + δuᵀJᵀJδu/2); NaN from the
    # descent means "not provided" (Dogleg gives it on its clipped branch)
    Jdu = mv(J, du)
    duJtJdu = torch.where(torch.isnan(descent_result.duJtJdu),
                          tree_dot(Jdu, Jdu), descent_result.duJtJdu)
    reads = [l2_norm(fu_new), l2_norm(fu), tree_dot(du, rmv_t(J, fu)),
             duJtJdu, l2_norm(du)]
    if cfg.method == "yuan":
        reads.append(l2_norm(_vjp_at(ctx, u_new, fu_new)))
    elif cfg.method == "bastin":
        # ρ re-estimated with the operators at u_NEW, as the reference does
        _, vjp_new = torch.func.vjp(ctx.f_flat, u_new)
        Jdu_new = jvp(ctx.f_flat, u_new, du)[1]
        jtfu_new = transpose_apply(lambda w: vjp_new(w)[0], fu_new)
        jt_jdu = transpose_apply(lambda w: vjp_new(w)[0], Jdu_new)
        reads += [tree_dot(jtfu_new, jtfu_new), tree_dot(jt_jdu, jt_jdu)]
    return u_new, fu_new, reads


def _rfunc_hei(r, c2, M, gamma1, gamma2, beta):
    """rfunc_adaptive_trust_region, in the working dtype."""
    npdt = type(r)
    if r >= c2:
        return ((npdt(2.0) * (M - npdt(1.0) - gamma2) * np.arctan(r - c2)
                 + (npdt(1.0) + gamma2)) / npdt(np.pi))
    return ((npdt(1.0) - gamma1 - beta)
            * (np.exp(r - c2) + beta / (npdt(1.0) - gamma1 - beta)))


def tr_update(cfg, state, host, descent_result: DescentResult, du):
    """The host half: from the read values of ``tr_candidate``'s reads,
    returns ``(accepted, new_state)``."""
    if isinstance(cfg, LevenbergMarquardtTrustRegion):
        return _lm_tr_update(cfg, state, host, descent_result, du)
    npdt = type(state.trust_region)
    with np.errstate(all="ignore"):
        fn_new, fn, du_jtfu, duJtJdu, du_norm = host[:5]
        num = (fn_new * fn_new - fn * fn) / npdt(2.0)
        rho = num / (du_jtfu + duJtJdu / npdt(2.0))

        stt = npdt(cfg.resolved_step_threshold())
        sht = npdt(cfg.resolved_shrink_threshold())
        et = npdt(cfg.resolved_expand_threshold())
        shf = npdt(cfg.resolved_shrink_factor())
        ef = npdt(cfg.resolved_expand_factor())

        accepted = bool(rho > stt)
        tr = state.trust_region
        shrink = bool(rho < sht)
        shrink_counter = state.shrink_counter + 1 if shrink else 0
        p1, p2, p3, p4 = state.p1, state.p2, state.p3, state.p4

        method = cfg.method
        if method == "simple":
            if shrink:
                tr = tr * shf
            elif rho > et and rho > stt:
                tr = ef * tr
        elif method == "nlsolve":
            if shrink:
                tr = tr * shf
            elif rho >= et:
                tr = ef * du_norm
            elif rho >= p1:
                tr = np.maximum(tr, ef * du_norm)
        elif method == "nocedalwright":
            if shrink:
                tr = shf * du_norm
            elif rho > et and abs(du_norm - tr) < npdt(1e-6) * tr:
                tr = ef * tr
        elif method == "hei":
            tr_new = _rfunc_hei(rho, sht, p1, p3, p4, p2) * du_norm
            shrink_counter = state.shrink_counter + 1 if tr_new < tr else 0
            tr = tr_new
        elif method == "yuan":
            if shrink:
                p1 = p2 * p1
            elif rho >= et and npdt(2.0) * du_norm > tr:
                p1 = p3 * p1
            tr = p1 * host[5]
        elif method == "fan":
            if shrink:
                p1 = p1 * p2
            elif rho > et:
                p1 = np.minimum(p1 * p3, p4)
            tr = p1 * (fn_new ** type(fn_new)(0.99))
        elif method == "bastin":
            rho_b = num / (host[5] + host[6] / npdt(2.0))
            if accepted:
                if rho_b >= et:
                    tr = p1 * du_norm
                shrink_counter = 0
            else:
                tr = tr * p2
                shrink_counter = state.shrink_counter + 1
        else:
            raise AssertionError(method)
        tr = np.minimum(tr, state.max_trust_radius)

    return accepted, TRState(
        trust_region=npdt(tr), max_trust_radius=state.max_trust_radius,
        p1=p1, p2=p2, p3=p3, p4=p4, shrink_counter=shrink_counter,
        last_step_accepted=accepted)


def _lm_tr_update(cfg: LevenbergMarquardtTrustRegion, state: LMTRState, host,
                  descent_result, du):
    norm_v, v_dot, loss = host
    npdt = type(state.loss_old)
    with np.errstate(all="ignore"):
        beta = v_dot / (norm_v * state.norm_v_old)
        # first step: norm_v_old = Inf → β = 0
        if not np.isfinite(beta):
            beta = npdt(0)
        accepted = bool((npdt(1.0) - beta) ** npdt(cfg.b_uphill) * loss
                        <= state.loss_old)
    if not accepted:
        return False, dataclasses.replace(state, last_step_accepted=False)
    v = descent_result.v if descent_result.v is not None else du
    return True, LMTRState(loss_old=loss, v_cache=v, norm_v_old=norm_v,
                           last_step_accepted=True)


def tr_shrink_counter(state) -> Any:
    """The shrink counter for the engine's ShrinkThresholdExceeded check;
    the LM trust region has none."""
    if isinstance(state, TRState):
        return state.shrink_counter
    return None

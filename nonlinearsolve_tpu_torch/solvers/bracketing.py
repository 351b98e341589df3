"""The bracketing tier (the port of ``solvers/bracketing.py``): Bisection,
Falsi, Ridder, Brent, ITP, Alefeld, Muller and the default ModAB on an
``IntervalNonlinearProblem``.

The JAX package writes each method as a scalar ``lax.while_loop``, so
``jax.vmap`` batches many brackets.  Here every method runs on a batch of
brackets, one row each ((B,) tensors: endpoints, their residuals, the
method's own state), in lockstep: each step is taken by the rows still
running and discarded for the others, so a row ends as its lone solve
does.  A problem whose endpoints and ``p`` are scalars is a batch of one.
The loop reads one flag a step (is any row still running?).

Retcodes as the reference's: ExactSolutionLeft/Right for an endpoint root,
InitialFailure for an interval that encloses no sign change,
FloatingPointLimit when the bracket closes to adjacent floats, Success on
|bracket|/2 < abstol (Muller: |f| ≤ abstol), MaxIters otherwise.

The derivative of the root with respect to ``p`` follows the implicit
function theorem, u̇ = −(∂f/∂p·ṗ)/(∂f/∂u), with zero tangents for the
endpoints (``_RootFunction``; differentiable again, so second derivatives
work).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from .. import _backend
from ..core.lockstep import row_flags, select_rows
from ..core.problems import IntervalNonlinearProblem
from ..core.returncode import ReturnCode
from ..core.solution import NLStats, NonlinearSolution
from ..utils.norms import get_tolerance


def _sign(x):
    """``jnp.sign``: NaN stays NaN (``torch.sign`` maps it to 0), so a NaN
    residual never compares equal to a sign."""
    return torch.where(torch.isnan(x), x, torch.sign(x))


@dataclasses.dataclass(frozen=True)
class Bisection:
    exact_left: bool = False
    exact_right: bool = False
    name: str = "Bisection"


@dataclasses.dataclass(frozen=True)
class Falsi:
    name: str = "Falsi"


@dataclasses.dataclass(frozen=True)
class Ridder:
    name: str = "Ridder"


@dataclasses.dataclass(frozen=True)
class Brent:
    name: str = "Brent"


@dataclasses.dataclass(frozen=True)
class ITP:
    scaled_k1: float = 0.2
    k2: float = 2.0
    n0: int = 10
    name: str = "ITP"

    def __post_init__(self):
        if self.scaled_k1 < 0:
            raise ValueError("scaled_k1 must be non-negative")
        if not (1 <= self.k2 <= 1.5 + 5 ** 0.5 / 2):
            raise ValueError("k2 must be in [1, 1+phi)")
        if self.n0 < 0:
            raise ValueError("n0 must be non-negative")


@dataclasses.dataclass(frozen=True)
class Alefeld:
    name: str = "Alefeld"


@dataclasses.dataclass(frozen=True)
class Muller:
    middle: Optional[float] = None
    name: str = "Muller"


@dataclasses.dataclass(frozen=True)
class ModAB:
    name: str = "ModAB"


BRACKETING_ALGS = (Bisection, Falsi, Ridder, Brent, ITP, Alefeld, Muller,
                   ModAB)


@dataclasses.dataclass(frozen=True)
class BracketCarry:
    """One row a bracket; every field a (B,) tensor (``extra``: a tuple of
    them, the method's own state)."""

    left: Any
    right: Any
    fl: Any
    fr: Any
    u: Any
    fu: Any
    extra: Any
    i: Any
    done: Any
    retcode: Any
    nf: Any

    def replace(self, **kw) -> "BracketCarry":
        return dataclasses.replace(self, **kw)


def _finish(c, u, fu, retcode):
    return c.replace(u=u, fu=fu, retcode=torch.full_like(c.retcode,
                                                         int(retcode)),
                     done=torch.ones_like(c.done))


def _nz(x):
    return torch.where(x == 0, torch.ones_like(x), x)


def _degenerate(mid, left, right):
    return (mid == left) | (mid == right)


def _run_bracketing(f, alg, left, right, abstol, maxiters):
    """The pre-checks and the method's loop on every row; returns the final
    carry.  ``f``: the residual of a batch of points, (B,) -> (B,)."""
    if not isinstance(alg, Muller):
        left, right = torch.minimum(left, right), torch.maximum(left, right)
    fl, fr = f(left), f(right)
    exact_l = fl == 0
    exact_r = (fr == 0) & ~exact_l
    if isinstance(alg, Muller):
        non_enclosing = torch.zeros_like(exact_l)      # Muller needs none
    else:
        non_enclosing = (_sign(fl) == _sign(fr)) & ~exact_l & ~exact_r
    code = lambda c: torch.full(left.shape, int(c), dtype=torch.int32,
                                device=left.device)
    pre_retcode = torch.where(
        exact_l, code(ReturnCode.ExactSolutionLeft),
        torch.where(exact_r, code(ReturnCode.ExactSolutionRight),
                    code(ReturnCode.InitialFailure)))
    step, extra0 = _make_step(f, alg, left, right, fl, fr, abstol)
    c = BracketCarry(
        left=left, right=right, fl=fl, fr=fr,
        u=torch.where(exact_r, right, left), fu=torch.where(exact_r, fr, fl),
        extra=extra0, i=torch.zeros_like(pre_retcode),
        done=exact_l | exact_r | non_enclosing, retcode=pre_retcode,
        nf=torch.full_like(pre_retcode, 2))
    while True:
        active = ~c.done & (c.i < maxiters)
        some, every = row_flags(active)
        if not some:
            break
        new = step(c).replace(i=c.i + 1)
        c = new if every else select_rows(active, new, c)
    return c.replace(
        retcode=torch.where(c.done, c.retcode, code(ReturnCode.MaxIters)),
        u=torch.where(c.done, c.u, c.left),
        fu=torch.where(c.done, c.fu, c.fl))


def _make_step(f, alg, left0, right0, fl0, fr0, abstol):
    """The per-iteration step of ``alg`` and its initial state."""
    dtype = left0.dtype
    eps = torch.finfo(dtype).eps

    if isinstance(alg, (Bisection, Falsi)):
        is_falsi = isinstance(alg, Falsi)

        def step(c):
            if is_falsi:
                # regula falsi with a midpoint fallback on stall
                mid_f = c.left - c.fl * (c.right - c.left) / _nz(c.fr - c.fl)
                stalled = (~torch.isfinite(mid_f)) | (mid_f <= c.left) | \
                    (mid_f >= c.right)
                mid = torch.where(stalled, (c.left + c.right) / 2, mid_f)
            else:
                mid = (c.left + c.right) / 2
            degenerate = _degenerate(mid, c.left, c.right)
            fm = f(mid)
            exact = fm == 0
            converged = ((c.right - c.left) / 2).abs() < abstol
            move_left = _sign(c.fl) == _sign(fm)
            new = c.replace(
                left=torch.where(move_left, mid, c.left),
                fl=torch.where(move_left, fm, c.fl),
                right=torch.where(move_left, c.right, mid),
                fr=torch.where(move_left, c.fr, fm), nf=c.nf + 1)
            done = _finish(new, mid, fm, ReturnCode.Success)
            return select_rows(degenerate,
                          _finish(c, c.left, c.fl,
                                  ReturnCode.FloatingPointLimit),
                          select_rows(exact | converged, done, new))

        return step, None

    if isinstance(alg, Ridder):
        def step(c):
            mid = (c.left + c.right) / 2
            degenerate = _degenerate(mid, c.left, c.right)
            fm = f(mid)
            s = torch.sqrt(torch.clamp(fm * fm - c.fl * c.fr, min=0.0))
            bad = s == 0
            x = mid + (mid - c.left) * _sign(c.fl - c.fr) * fm / \
                torch.where(bad, torch.ones_like(s), s)
            x = torch.minimum(torch.maximum(x, torch.minimum(c.left,
                                                             c.right)),
                              torch.maximum(c.left, c.right))
            fx = f(x)
            exact = fx == 0
            converged = ((c.right - c.left) / 2).abs() < abstol
            # rebracket with the (mid, x) pair, else keep the sign change
            use_mx = _sign(fm) != _sign(fx)
            l1 = torch.where(use_mx, torch.minimum(mid, x), c.left)
            f1 = torch.where(use_mx, torch.where(mid < x, fm, fx), c.fl)
            r1 = torch.where(use_mx, torch.maximum(mid, x), c.right)
            f2 = torch.where(use_mx, torch.where(mid < x, fx, fm), c.fr)
            keep_left = _sign(c.fl) != _sign(fx)
            l2 = torch.where(keep_left, c.left, x)
            fl2 = torch.where(keep_left, c.fl, fx)
            r2 = torch.where(keep_left, x, c.right)
            fr2 = torch.where(keep_left, fx, c.fr)
            new = c.replace(left=torch.where(use_mx, l1, l2),
                            fl=torch.where(use_mx, f1, fl2),
                            right=torch.where(use_mx, r1, r2),
                            fr=torch.where(use_mx, f2, fr2), nf=c.nf + 2)
            done = _finish(new, x, fx, ReturnCode.Success)
            return select_rows(degenerate,
                          _finish(c, c.left, c.fl,
                                  ReturnCode.FloatingPointLimit),
                          select_rows(exact | bad | converged, done, new))

        return step, None

    if isinstance(alg, Brent):
        # extra = (c, d, bisected), the reference's convention
        swap0 = fl0.abs() < fr0.abs()
        left_i = torch.where(swap0, right0, left0)

        def step(c):
            cc, d, bisected = c.extra
            fc = f(cc)
            use_iqi = (c.fl != fc) & (c.fr != fc)
            s_iqi = (c.left * c.fr * fc / ((c.fl - c.fr) * (c.fl - fc))
                     + c.right * c.fl * fc / ((c.fr - c.fl) * (c.fr - fc))
                     + cc * c.fl * c.fr / ((fc - c.fl) * (fc - c.fr)))
            s_sec = c.right - c.fr * (c.right - c.left) / (c.fr - c.fl)
            s = torch.where(use_iqi, s_iqi, s_sec)
            q = (3 * c.left + c.right) / 4
            lo, hi = torch.minimum(q, c.right), torch.maximum(q, c.right)
            need_bisect = ((s < lo) | (s > hi)
                           | (bisected & ((s - c.right).abs()
                                          >= (c.right - cc).abs() / 2))
                           | (~bisected & ((s - c.right).abs()
                                           >= (cc - d).abs() / 2))
                           | (bisected & ((c.right - cc).abs() <= eps))
                           | (~bisected & ((cc - d).abs() <= eps))
                           | ~torch.isfinite(s))
            s_b = (c.left + c.right) / 2
            degenerate = need_bisect & _degenerate(s_b, c.left, c.right)
            s = torch.where(need_bisect, s_b, s)
            fs = f(s)
            exact = fs == 0
            converged = ((c.right - c.left) / 2).abs() < abstol
            sign_change = c.fl * fs < 0
            d_new = torch.where(sign_change, cc, d)
            c_new = torch.where(sign_change, c.right, cc)
            right_new = torch.where(sign_change, s, c.right)
            fr_new = torch.where(sign_change, fs, c.fr)
            left_new = torch.where(sign_change, c.left, s)
            fl_new = torch.where(sign_change, c.fl, fs)
            # keep |fl| ≥ |fr| by swapping
            swap = fl_new.abs() < fr_new.abs()
            d_new = torch.where(swap, c_new, d_new)
            c_new2 = torch.where(swap, right_new, c_new)
            new = c.replace(left=torch.where(swap, right_new, left_new),
                            fl=torch.where(swap, fr_new, fl_new),
                            right=torch.where(swap, left_new, right_new),
                            fr=torch.where(swap, fl_new, fr_new),
                            extra=(c_new2, d_new, need_bisect), nf=c.nf + 2)
            done = _finish(new, s, fs, ReturnCode.Success)
            return select_rows(degenerate,
                          _finish(c, c.left, c.fl,
                                  ReturnCode.FloatingPointLimit),
                          select_rows(exact | converged, done, new))

        return step, (left_i, left_i, torch.ones_like(swap0))

    if isinstance(alg, ITP):
        span0 = right0 - left0
        k1 = alg.scaled_k1 * span0 ** (1 - alg.k2)
        n_h = torch.ceil(torch.log2(torch.clamp(span0 / (2 * abstol),
                                                min=1.0)))
        eps_s0 = abstol * torch.exp2(n_h) * 2.0 ** alg.n0

        def step(c):
            eps_s = c.extra
            span = c.right - c.left
            mid = (c.left + c.right) / 2
            r = eps_s - span / 2
            x_f = c.left + span * (c.fl / _nz(c.fl - c.fr))
            delta = torch.maximum(k1 * span ** alg.k2,
                                  x_f.abs() * eps + eps)
            diff = mid - x_f
            xt = torch.where(delta <= diff.abs(),
                             x_f + _sign(diff) * delta, mid)
            xp = torch.where((xt - mid).abs() <= r, xt,
                             mid - _sign(diff) * r)
            small = span < 2 * abstol
            yp = f(xp)
            yps = yp * _sign(c.fr)
            go_right, go_left = yps > 0, yps < 0
            new = c.replace(
                left=torch.where(go_left, xp, c.left),
                fl=torch.where(go_left, yp, c.fl),
                right=torch.where(go_right, xp, c.right),
                fr=torch.where(go_right, yp, c.fr),
                extra=eps_s / 2, nf=c.nf + 1)
            fp_limit = torch.nextafter(new.left, new.right) == new.right
            return select_rows(
                small, _finish(c, xt, f(xt), ReturnCode.Success),
                select_rows(yps == 0, _finish(new, xp, yps, ReturnCode.Success),
                       select_rows(fp_limit,
                              _finish(new, new.right, new.fr,
                                      ReturnCode.FloatingPointLimit),
                              new)))

        return step, eps_s0

    if isinstance(alg, Alefeld):
        # Alefeld–Potra–Shi (1995) algorithm 4.2-style: two
        # Newton-quadratic substeps, a double-length secant, and a
        # bisection when the bracket has not shrunk by μ = 1/2
        mu = 0.5

        def nq(a, b, d, fa, fb, fd):
            """A Newton-quadratic step on the quadratic through (a, b, d):
            two Newton iterations on it (a ``lax.scan`` of two in the JAX
            package)."""
            Bq = (fb - fa) / (b - a)
            A = ((fd - fb) / (d - b) - Bq) / (d - a)
            r = a - fa / Bq
            r2 = r
            for _ in range(2):
                P = fa + Bq * (r2 - a) + A * (r2 - a) * (r2 - b)
                Pp = Bq + A * (2 * r2 - a - b)
                r_new = r2 - P / _nz(Pp)
                r2 = torch.where(torch.isfinite(r_new), r_new, r2)
            return torch.where((A == 0) | ~torch.isfinite(r2), r, r2)

        def inside(x, a, b):
            return torch.minimum(torch.maximum(x, torch.nextafter(a, b)),
                                 torch.nextafter(b, a))

        def bracket(a, b, fa, fb, x, fx):
            """Keep the sign-changing half: a, b, d, fa, fb, fd."""
            keep = _sign(fa) != _sign(fx)
            return (torch.where(keep, a, x), torch.where(keep, x, b),
                    torch.where(keep, b, a), torch.where(keep, fa, fx),
                    torch.where(keep, fx, fb), torch.where(keep, fb, fa))

        def step(c):
            d, fd = c.extra
            a, b, fa, fb = c.left, c.right, c.fl, c.fr
            span_in = b - a
            x1 = inside(nq(a, b, d, fa, fb, fd), a, b)
            fx1 = f(x1)
            a1, b1, d1, fa1, fb1, fd1 = bracket(a, b, fa, fb, x1, fx1)
            x2 = inside(nq(a1, b1, d1, fa1, fb1, fd1), a1, b1)
            fx2 = f(x2)
            a2, b2, d2, fa2, fb2, fd2 = bracket(a1, b1, fa1, fb1, x2, fx2)
            # the double-length secant from the smaller-|f| endpoint
            use_a = fa2.abs() < fb2.abs()
            u = torch.where(use_a, a2, b2)
            fu_ = torch.where(use_a, fa2, fb2)
            xs = u - 2 * fu_ * (b2 - a2) / _nz(fb2 - fa2)
            xs = torch.where((xs - u).abs() > (b2 - a2) / 2,
                             (a2 + b2) / 2, xs)
            xs = inside(xs, a2, b2)
            fxs = f(xs)
            a3, b3, d3, fa3, fb3, fd3 = bracket(a2, b2, fa2, fb2, xs, fxs)
            need_bisect = (b3 - a3) >= mu * span_in
            mid = (a3 + b3) / 2
            fmid = f(mid)
            bis = bracket(a3, b3, fa3, fb3, mid, fmid)
            a4, b4, d4, fa4, fb4, fd4 = [
                torch.where(need_bisect, x, y)
                for x, y in zip(bis, (a3, b3, d3, fa3, fb3, fd3))]
            exact = (fx1 == 0) | (fx2 == 0) | (fxs == 0) | \
                (need_bisect & (fmid == 0))
            exact_u = torch.where(fx1 == 0, x1, torch.where(
                fx2 == 0, x2, torch.where(fxs == 0, xs, mid)))
            converged = ((b4 - a4) / 2).abs() < abstol
            fp_limit = torch.nextafter(a4, b4) >= b4
            a_best = fa4.abs() < fb4.abs()
            best = torch.where(a_best, a4, b4)
            fbest = torch.where(a_best, fa4, fb4)
            new = c.replace(left=a4, right=b4, fl=fa4, fr=fb4,
                            extra=(d4, fd4), nf=c.nf + 4)
            return select_rows(
                exact, _finish(new, exact_u, torch.zeros_like(fx1),
                               ReturnCode.Success),
                select_rows(converged,
                       _finish(new, best, fbest, ReturnCode.Success),
                       select_rows(fp_limit,
                              _finish(new, best, fbest,
                                      ReturnCode.FloatingPointLimit),
                              new)))

        d0 = (left0 + right0) / 2
        return step, (d0, f(d0))

    if isinstance(alg, Muller):
        xm0 = ((left0 + right0) / 2 if alg.middle is None
               else torch.full_like(left0, alg.middle))

        def step(c):
            x0, x1, x2, f0, f1, f2 = c.extra
            q = (x2 - x1) / (x1 - x0)
            A = q * f2 - q * (1 + q) * f1 + q * q * f0
            Bm = (2 * q + 1) * f2 - (1 + q) ** 2 * f1 + q * q * f0
            C = (1 + q) * f2
            disc = torch.sqrt(torch.clamp(Bm * Bm - 4 * A * C, min=0.0))
            denom_p, denom_m = Bm + disc, Bm - disc
            denom = torch.where(denom_p.abs() >= denom_m.abs(), denom_p,
                                denom_m)
            x3 = x2 - (x2 - x1) * 2 * C / _nz(denom)
            f3 = f(x3)
            new = c.replace(extra=(x1, x2, x3, f1, f2, f3), u=x3, fu=f3,
                            nf=c.nf + 1)
            return select_rows(f3.abs() <= abstol,
                          _finish(new, x3, f3, ReturnCode.Success), new)

        return step, (left0, xm0, right0, fl0, f(xm0), fr0)

    if isinstance(alg, ModAB):
        C = 16.0

        def step(c):
            bisecting, side, threshold = c.extra
            # the bisection branch
            x3_b = (c.left + c.right) / 2
            y3_b = f(x3_b)
            ym = (c.fl + c.fr) / 2
            r = 1 - (ym / (c.fr - c.fl)).abs()
            k = r * r
            switch_to_ab = (ym - y3_b).abs() < k * (ym.abs() + y3_b.abs())
            # the Anderson–Björck branch
            x3_ab = (c.left * c.fr - c.fl * c.right) / _nz(c.fr - c.fl)
            x3_ab = torch.minimum(
                torch.maximum(x3_ab, torch.nextafter(c.left, c.right)),
                torch.nextafter(c.right, c.left))
            x3 = torch.where(bisecting, x3_b, x3_ab)
            y3 = torch.where(bisecting, y3_b, f(x3_ab))
            threshold = torch.where(
                bisecting,
                torch.where(switch_to_ab, (c.right - c.left) * C, threshold),
                threshold / 2)
            bisecting_new = bisecting & ~switch_to_ab
            exact = y3 == 0
            converged = (c.right - c.left) < 2 * abstol
            same_side_left = _sign(c.fl) == _sign(y3)
            # the Anderson–Björck corrections
            m_r = 1 - y3 / c.fl
            corr_r = torch.where(m_r <= 0, 0.5, m_r)
            fr_corr = torch.where(same_side_left & (side == 1),
                                  c.fr * corr_r, c.fr)
            m_l = 1 - y3 / c.fr
            corr_l = torch.where(m_l <= 0, 0.5, m_l)
            fl_corr = torch.where(~same_side_left & (side == -1),
                                  c.fl * corr_l, c.fl)
            side_new = torch.where(
                bisecting_new | bisecting, side,
                torch.where(same_side_left, torch.ones_like(side),
                            -torch.ones_like(side)))
            new_left = torch.where(same_side_left, x3, c.left)
            new_fl = torch.where(same_side_left, y3, fl_corr)
            new_right = torch.where(same_side_left, c.right, x3)
            new_fr = torch.where(same_side_left, fr_corr, y3)
            fp_limit = torch.nextafter(new_left, new_right) == new_right
            # back to bisection when AB fails to shrink the bracket
            reset = (new_right - new_left) > threshold
            new = c.replace(
                left=new_left, fl=new_fl, right=new_right, fr=new_fr,
                extra=(bisecting_new | reset,
                       torch.where(reset, torch.zeros_like(side), side_new),
                       threshold),
                nf=c.nf + 1)
            return select_rows(
                exact | converged, _finish(new, x3, y3, ReturnCode.Success),
                select_rows(fp_limit,
                       _finish(new, new.right, new.fr,
                               ReturnCode.FloatingPointLimit),
                       new))

        return step, (torch.ones_like(fl0, dtype=torch.bool),
                      torch.zeros_like(fl0, dtype=torch.int32),
                      right0 - left0)

    raise ValueError(f"unknown bracketing algorithm {alg!r}")


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def _dtype_of(x) -> torch.dtype:
    """A Python number counts as float64 (as ``jnp.asarray`` of one is
    under x64); a tensor keeps its dtype."""
    if isinstance(x, torch.Tensor):
        return x.dtype if x.is_floating_point() else torch.float64
    return torch.float64


def _batch_of(*xs) -> Optional[int]:
    sizes = {x.shape[0] for x in xs if isinstance(x, torch.Tensor)
             and x.dim() == 1}
    if len(sizes) > 1:
        raise ValueError(f"batched endpoints and p differ in length: "
                         f"{sorted(sizes)}")
    return sizes.pop() if sizes else None


@dataclasses.dataclass(frozen=True)
class _RootSpec:
    """What the root function needs besides ``p``: the one-point residual
    and how ``p`` maps onto the rows."""

    f: Any
    pdim: Optional[int]
    batched: bool


def _partials(spec: _RootSpec, u, p):
    """∂f/∂u and ∂f/∂p at each row's (u, p), each a function of both (so
    a derivative of them is the derivative of the partials)."""
    f = spec.f
    grads = torch.func.grad(lambda x, q: f(x, q), argnums=(0, 1))
    if spec.batched:
        return torch.func.vmap(grads, in_dims=(0, spec.pdim))(u, p)
    return grads(u, p)


class _RootFunction(torch.autograd.Function):
    """u(p) at the solved root ``u_val``: the forward returns the root; the
    backward is the implicit-function rule, evaluated on u(p) rebuilt
    through this same function, so that it is differentiable again."""

    @staticmethod
    def forward(ctx, p, u_val, spec):
        ctx.save_for_backward(p, u_val)
        ctx.spec = spec
        return u_val.clone()

    @staticmethod
    def backward(ctx, gu):
        p, u_val = ctx.saved_tensors
        spec = ctx.spec
        u = _RootFunction.apply(p, u_val, spec)
        dfdu, dfdp = _partials(spec, u, p)
        du = -dfdp / torch.where(dfdu == 0, torch.ones_like(dfdu), dfdu)
        gp = gu * du
        if spec.batched and spec.pdim is None:
            gp = gp.sum()
        return gp.reshape(p.shape), None, None


def _vmapped(f, p, pdim):
    def fb(x):
        return torch.func.vmap(f, in_dims=(0, pdim))(x, p)
    return fb


def _say_non_enclosing(verbose, retcode, lt, rt) -> None:
    """The ``non_enclosing_interval`` message, once for each interval that
    encloses no sign change (a read of the codes when the class is on)."""
    from ..core.verbosity import normalize_verbosity
    vrb = normalize_verbosity(verbose)
    if vrb is None or not vrb.enabled("non_enclosing_interval"):
        return
    codes = (retcode.reshape(-1) if isinstance(retcode, torch.Tensor)
             else torch.tensor([int(retcode)]))
    codes, left, right = _backend.fetch(codes.to(lt.device).int(), lt, rt)
    for code, a, b in zip(codes, left, right):
        if int(code) == int(ReturnCode.InitialFailure):
            vrb.emit("non_enclosing_interval",
                     f"the interval ({float(a)}, {float(b)}) does not "
                     "enclose a sign change; returning InitialFailure "
                     "(BracketingNonlinearSolve pre-check)")


def solve_bracketing(prob: IntervalNonlinearProblem, alg=None, *,
                     abstol=None, maxiters=1000, verbose=None,
                     **_ignored) -> NonlinearSolution:
    """Solve an ``IntervalNonlinearProblem`` (default: ModAB) on the device
    of its tensors (the card when none of ``tspan`` and ``p`` is one).  The
    dtype is that of the endpoints, float32 at least; Python floats count
    as float64.  With 1-d endpoints or ``p`` (length B) the solution's
    ``u``, ``resid``, ``retcode`` and stats carry the batch axis; else
    they are scalars (retcode a ``ReturnCode``, stats ints, read in one
    host sync).  ``original``: the final bracket ``(left, right)``."""
    if alg is None:
        alg = ModAB()
    if not isinstance(alg, BRACKETING_ALGS):
        raise ValueError(f"cannot solve an IntervalNonlinearProblem with "
                         f"{alg!r}: use a bracketing method")
    left, right = prob.tspan
    p = prob.p
    tensors = [x for x in (left, right, p) if isinstance(x, torch.Tensor)]
    if isinstance(p, (tuple, list)):
        tensors += [x for x in p if isinstance(x, torch.Tensor)]
    dev = (tensors[0].device if tensors
           else _backend.resolve_device(None))
    dtype = torch.promote_types(
        torch.promote_types(_dtype_of(left), _dtype_of(right)),
        torch.float32)
    B = _batch_of(left, right, p)
    batched = B is not None
    rows = B if batched else 1

    def endpoint(x):
        t = torch.as_tensor(x, dtype=dtype, device=dev)
        return t.expand(rows).contiguous() if t.dim() == 0 else t

    lt, rt = endpoint(left), endpoint(right)
    pdim = 0 if (isinstance(p, torch.Tensor) and p.dim() == 1
                 and batched) else None
    f = prob.f.f
    npdt = _backend.np_dtype(dtype)
    abstol_v = float(npdt(get_tolerance(abstol, npdt)))
    syncs0 = _backend.HOST_SYNCS["n"]
    with torch.no_grad():
        final = _run_bracketing(_vmapped(f, p, pdim), alg, lt, rt, abstol_v,
                                int(maxiters))
    u = final.u if batched else final.u[0]
    if (isinstance(p, torch.Tensor) and p.requires_grad
            and torch.is_grad_enabled()):
        u = _RootFunction.apply(p, u, _RootSpec(f=f, pdim=pdim,
                                                batched=batched))
    stats = NLStats(nf=final.nf, njacs=torch.zeros_like(final.nf),
                    nfactors=torch.zeros_like(final.nf),
                    nsolve=torch.zeros_like(final.nf), nsteps=final.i)
    retcode = final.retcode
    resid, original = final.fu, (final.left, final.right)
    if not batched:
        codes = _backend.fetch(retcode, final.nf, final.i)
        retcode = ReturnCode(int(codes[0][0]))
        nf, nsteps = int(codes[1][0]), int(codes[2][0])
        stats = NLStats(nf=nf, nsteps=nsteps)
        resid, original = resid[0], (final.left[0], final.right[0])
    _say_non_enclosing(verbose, retcode, lt, rt)
    return NonlinearSolution(
        u=u, resid=resid, retcode=retcode, stats=stats,
        counters={"host_syncs": _backend.HOST_SYNCS["n"] - syncs0},
        original=original)

"""The simple tier (the port of ``solvers/simple.py``): SimpleNewtonRaphson,
SimpleGaussNewton, SimpleBroyden, SimpleKlement, SimpleDFSane,
SimpleHalley, SimpleTrustRegion and SimpleLimitedMemoryBroyden.

The JAX package writes each as a small ``lax.while_loop`` on the flattened
state, so ``jax.vmap`` batches whole solves.  ``torch.vmap`` cannot batch
a loop whose trip count depends on the data, so here every engine runs on
an explicit leading batch dimension: the state is (B, n), one row a
trajectory, and the loop runs in lockstep over the rows until every row
has stopped.  A row that has stopped keeps its carry (u, fu, retcode,
stats and the engine's own state) bit for bit, as a finished lane of a
vmapped ``while_loop`` does; so each row ends with what its lone solve
gives.  A solve of one problem is the loop at B = 1.

The residual of a batch is ``torch.func.vmap`` of the one-row residual
over (u, p) (``BatchedResidual``); Jacobians are ``vmap(jacfwd)`` or the
analytic ``jac`` vmapped; dense solves are ``solve_dense_batched``
(Gauss–Jordan for n ≤ 32, a CUDA graph a shape on the card).  Every
decision is a ``torch.where`` on the device; the loop reads one flag a
step (is any row still running?), and the line searches one a trial.
Default termination: AbsNorm (the :simple callee).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from .. import _backend
from ..core import linesearch as lsr
from ..core import termination as trm
from ..core.autodiff import jacfwd, jvp
from ..core.linesearch import ipow
from ..core.lockstep import row_flags, select_rows
from ..core.returncode import ReturnCode
from ..core.solution import NLStats
from ..ops.linear_solve import _lstsq, solve_dense_batched
from ..utils import ordering
from ..utils.pytree import tree_map


@dataclasses.dataclass(frozen=True)
class SimpleNewtonRaphson:
    name: str = "SimpleNewtonRaphson"
    default_termination_callee = "simple"


def SimpleGaussNewton(**kw):
    return SimpleNewtonRaphson(**kw)


@dataclasses.dataclass(frozen=True)
class SimpleBroyden:
    linesearch: bool = False      # True → Li-Fukushima line search
    alpha: Optional[float] = None
    name: str = "SimpleBroyden"
    default_termination_callee = "simple"


@dataclasses.dataclass(frozen=True)
class SimpleKlement:
    name: str = "SimpleKlement"
    default_termination_callee = "simple"


@dataclasses.dataclass(frozen=True)
class SimpleDFSane:
    sigma_min: float = 1e-10
    sigma_max: float = 1e10
    sigma_1: float = 1.0
    M: int = 10
    gamma: float = 1e-4
    tau_min: float = 0.1
    tau_max: float = 0.5
    n_exp: int = 2
    max_inner_iterations: int = 100
    name: str = "SimpleDFSane"
    default_termination_callee = "simple"


@dataclasses.dataclass(frozen=True)
class SimpleHalley:
    name: str = "SimpleHalley"
    default_termination_callee = "simple"


@dataclasses.dataclass(frozen=True)
class SimpleTrustRegion:
    """``nlsolve_update_rule=True`` switches to the NLSolve.jl radius rule:
    shrink threshold 0.05, expand threshold 0.9, shrink factor 0.5, initial
    radius ‖x₀‖ (or 1), and a step-length-based expansion."""
    max_trust_radius: Optional[float] = None
    initial_trust_radius: Optional[float] = None
    step_threshold: float = 0.0001
    shrink_threshold: Optional[float] = None
    expand_threshold: Optional[float] = None
    shrink_factor: Optional[float] = None
    expand_factor: float = 2.0
    max_shrink_times: int = 32
    nlsolve_update_rule: bool = False
    name: str = "SimpleTrustRegion"
    default_termination_callee = "simple"


@dataclasses.dataclass(frozen=True)
class SimpleLimitedMemoryBroyden:
    threshold: int = 27
    linesearch: bool = False
    alpha: Optional[float] = None
    name: str = "SimpleLimitedMemoryBroyden"
    default_termination_callee = "simple"


SIMPLE_ALGS = (SimpleNewtonRaphson, SimpleBroyden, SimpleKlement, SimpleDFSane,
               SimpleHalley, SimpleTrustRegion, SimpleLimitedMemoryBroyden)


def is_simple_alg(alg) -> bool:
    return isinstance(alg, SIMPLE_ALGS)


# ---------------------------------------------------------------------------
# the batched residual
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchedResidual:
    """The residual of a batch of flat rows.  ``f1(u, p) -> fu``: one row
    (n,) -> (m,); ``p`` is shared by the rows (``pdim`` None) or holds one
    parameter a row along its first axis (``pdim`` 0).  ``jac1(u, p) ->
    (m, n)``: the analytic Jacobian of one row, or None (forward AD).
    ``batched(X, p) -> (B, m)``: the residual of all rows at once (a
    loaded ``torch.export`` program of the batched residual,
    ``utils/aot.py``), which then takes the place of ``vmap(f1)``;
    ``jac_batched(X, p) -> (B, m, n)`` likewise the loaded program of the
    batched analytic Jacobian, in place of ``vmap(jac1)``."""

    f1: Callable
    p: Any
    pdim: Optional[int]
    n_out: int
    jac1: Optional[Callable] = None
    is_least_squares: bool = False
    batched: Optional[Callable] = None
    jac_batched: Optional[Callable] = None

    def __call__(self, X):
        if self.batched is not None:
            return self.batched(X, self.p)
        return torch.func.vmap(self.f1, in_dims=(0, self.pdim))(X, self.p)

    def jac(self, X):
        """The Jacobians (B, m, n): the analytic one where given."""
        if self.jac1 is None:
            return self.jacfwd(X)
        if self.jac_batched is not None:
            return self.jac_batched(X, self.p)
        return torch.func.vmap(self.jac1, in_dims=(0, self.pdim))(X, self.p)

    def jacfwd(self, X):
        if self.batched is not None:
            # the JVPs on the unit tangents, as one batch of n·B rows: row
            # k·B + i is row i with tangent e_k
            B, n = X.shape
            eye = torch.eye(n, dtype=X.dtype, device=X.device)
            tile = lambda v: v.repeat((n,) + (1,) * (v.dim() - 1))  # noqa
            p = self.p if self.pdim is None else tree_map(tile, self.p)
            # torch.autograd's forward mode: torch.func's jvp meets an
            # internal assert in a program with a symbolic batch
            from torch.autograd import forward_ad
            with forward_ad.dual_level():
                out = self.batched(forward_ad.make_dual(
                    tile(X), eye.repeat_interleave(B, 0)), p)
                cols = forward_ad.unpack_dual(out).tangent
            return cols.reshape(n, B, -1).permute(1, 2, 0)
        return torch.func.vmap(jacfwd(self.f1),
                               in_dims=(0, self.pdim))(X, self.p)

    def hvvp(self, X, A):
        """d²f(x)[a, a] of each row, by jvp of jvp."""
        f1 = self.f1

        def one(x, a, p):
            def df(y):
                return jvp(lambda z: f1(z, p), y, a)[1]
            return jvp(df, x, a)[1]

        return torch.func.vmap(one, in_dims=(0, 0, self.pdim))(X, A, self.p)


# ---------------------------------------------------------------------------
# the lockstep loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SimpleCarry:
    """One row a trajectory: ``u``, ``xo``, ``fu`` (B, ·); ``extra`` the
    engine's state (tensors with a leading B); ``nsteps``, ``force_stop``,
    ``retcode`` (B,); ``stats`` an ``NLStats`` of (B,) tensors."""

    u: Any
    xo: Any
    fu: Any
    extra: Any
    nsteps: Any
    force_stop: Any
    retcode: Any
    stats: Any
    term: Any

    def replace(self, **kw) -> "SimpleCarry":
        return dataclasses.replace(self, **kw)


def _run_simple(res: BatchedResidual, term_cfg, abstol, reltol, maxiters,
                x0, extra0, step_fn, nf_init=1, njacs_init=0):
    """The JAX package's ``_run_simple`` on every row in lockstep; each
    step is taken by the rows still running and discarded for the others.
    ``step_fn(c, active) -> (x, fx, extra, nf, njacs, nsolve, fail)``."""
    B, dev = x0.shape[0], x0.device
    fx0 = res(x0)
    term = trm.init_termination_batched(term_cfg, fx0, x0, reltol)
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    stats = NLStats(zeros, zeros, zeros, zeros, zeros).incr(
        nf=nf_init, njacs=njacs_init)
    c = SimpleCarry(u=x0, xo=x0, fu=fx0, extra=extra0, nsteps=zeros,
                    force_stop=torch.zeros(B, dtype=torch.bool, device=dev),
                    retcode=torch.full_like(zeros, int(ReturnCode.Default)),
                    stats=stats,
                    term=term)
    while True:
        active = ~c.force_stop & (c.nsteps < maxiters)
        some, every = row_flags(active)
        if not some:
            break
        x_new, fx_new, extra, nf, njacs, nsolve, fail = step_fn(c, active)
        stop, term = trm.check_termination_batched(
            term_cfg, c.term, fx_new, x_new, c.u, abstol, reltol,
            is_least_squares=res.is_least_squares)
        retcode = torch.where(stop, term.retcode, int(ReturnCode.Default))
        retcode = torch.where(fail, int(ReturnCode.Unstable), retcode)
        new = SimpleCarry(
            u=x_new, xo=c.u, fu=fx_new, extra=extra, nsteps=c.nsteps + 1,
            force_stop=c.force_stop | stop | fail, retcode=retcode,
            stats=c.stats.incr(nf=nf, njacs=njacs, nsolve=nsolve, nsteps=1),
            term=term)
        c = new if every else select_rows(active, new, c)
    retcode = torch.where(
        c.retcode == int(ReturnCode.Default),
        torch.where(c.nsteps >= maxiters, int(ReturnCode.MaxIters),
                    int(ReturnCode.Success)).to(c.retcode.dtype),
        c.retcode)
    if term_cfg.keeps_best:
        x_final = c.term.best_u
        fx_final = res(x_final)
    else:
        x_final, fx_final = c.u, c.fu
    return c.replace(u=x_final, fu=fx_final, retcode=retcode)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def _mv(A, x):
    """A @ x for each row: (B, m, n), (B, n) -> (B, m)."""
    return torch.matmul(A, x[..., None])[..., 0]


def _dot(a, b):
    return (a * b).sum(-1)


def _l2(x):
    return torch.linalg.vector_norm(x, dim=-1)


def _init_alpha(alpha, x, fx):
    """α = max(‖x‖, 1)/(2‖fx‖) if ‖fx‖ ≥ 1e-5 else 1; a user α → 1/α."""
    fx_norm = _l2(fx)
    if alpha is not None:
        return torch.full_like(fx_norm, 1.0 / alpha)
    return torch.where(fx_norm >= 1e-5,
                       torch.clamp(_l2(x), min=1.0) / (2.0 * fx_norm),
                       torch.ones_like(fx_norm))


def _no_fail(c):
    return torch.zeros_like(c.force_stop)


def run_simple_newton(alg, res, term_cfg, x0, abstol, reltol, maxiters):
    square = res.n_out == x0.shape[-1]

    def step(c, active):
        J = res.jac(c.u)
        if square:
            dx, ok = solve_dense_batched(J, c.fu)
        else:
            dx = _lstsq(J, c.fu)[0]
            ok = torch.isfinite(dx).all(-1)
        x = c.u - dx
        return x, res(x), c.extra, 1, 1, 1, ~ok

    return _run_simple(res, term_cfg, abstol, reltol, maxiters, x0, None,
                       step)


def run_simple_broyden(alg, res, term_cfg, x0, abstol, reltol, maxiters):
    fx0 = res(x0)
    B, n = x0.shape
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    Jinv0 = eye * _init_alpha(alg.alpha, x0, fx0)[:, None, None]
    ls_cfg = lsr.LiFukushimaLineSearch() if alg.linesearch else None

    def step(c, active):
        Jinv, fprev = c.extra
        dx = -_mv(Jinv, fprev)
        if ls_cfg is not None:
            alpha_s, _, nf_ls = lsr.li_fukushima_batched(
                ls_cfg, res, c.u, dx, fprev, c.nsteps, active)
        else:
            alpha_s, nf_ls = torch.ones_like(dx[:, 0]), 0
        x = torch.addcmul(c.u, alpha_s[:, None], dx)
        fx = res(x)
        df = fx - fprev
        # the secant Δu = α·dx, the step actually taken
        s = alpha_s[:, None] * dx
        Jdf = _mv(Jinv, df)
        d = _dot(s, Jdf)
        d = torch.where(d == 0, 1e-5, d)
        row = torch.matmul(s[:, None, :], Jinv)[:, 0]
        Jinv_new = torch.addcmul(Jinv, ((s - Jdf) / d[:, None])[:, :, None],
                                 row[:, None, :])
        return x, fx, (Jinv_new, fx), 1 + nf_ls, 0, 1, _no_fail(c)

    return _run_simple(res, term_cfg, abstol, reltol, maxiters, x0,
                       (Jinv0, fx0), step)


def run_simple_klement(alg, res, term_cfg, x0, abstol, reltol, maxiters):
    def step(c, active):
        J, fprev = c.extra
        J = torch.where(J == 0, torch.ones_like(J), J)
        dx = fprev / J
        x = c.u - dx
        fx = res(x)
        dx = -dx
        dx2 = dx * dx * J * J
        dx2 = torch.where(dx2 == 0, 1e-5, dx2)
        # J + (fx - fprev - J·dx)/dx2·dx·J·J with the two fused
        # multiply-adds XLA makes of it (so a step rounds as the JAX
        # package's does)
        r = torch.addcmul(fx - fprev, J, dx, value=-1.0) / dx2 * dx * J
        J_new = torch.addcmul(J, r, J)
        return x, fx, (J_new, fx), 1, 0, 1, _no_fail(c)

    return _run_simple(res, term_cfg, abstol, reltol, maxiters, x0,
                       (torch.ones_like(x0), res(x0)), step)


def run_simple_halley(alg, res, term_cfg, x0, abstol, reltol, maxiters):
    """a = J⁻¹f, b = J⁻¹(d²f[a,a]), x += a²/(-a + b/2)."""
    eps = torch.finfo(x0.dtype).eps

    def step(c, active):
        J = res.jacfwd(c.u)
        a, ok1 = solve_dense_batched(J, c.fu)
        b, ok2 = solve_dense_batched(J, res.hvvp(c.u, a))
        denom = -a + 0.5 * b
        denom = torch.where(denom == 0, eps, denom)
        x = c.u + (a * a) / denom
        return x, res(x), c.extra, 3, 1, 2, ~(ok1 & ok2)

    return _run_simple(res, term_cfg, abstol, reltol, maxiters, x0, None,
                       step)


def run_simple_dfsane(alg: SimpleDFSane, res, term_cfg, x0, abstol, reltol,
                      maxiters):
    ls_cfg = lsr.RobustNonMonotoneLineSearch(
        gamma=alg.gamma, sigma_1=alg.sigma_1, M=alg.M, tau_min=alg.tau_min,
        tau_max=alg.tau_max, n_exp=alg.n_exp,
        maxiters=alg.max_inner_iterations)
    fx0 = res(x0)
    ls_state0 = lsr.rnm_init_batched(ls_cfg, fx0)
    sigma0 = torch.full_like(fx0[:, 0], alg.sigma_1)

    def step(c, active):
        sigma, ls_state = c.extra
        dx = -sigma[:, None] * c.fu
        alpha, _, nf_ls = lsr.robust_nonmonotone_batched(
            ls_cfg, ls_state, res, c.u, dx, c.fu, active)
        x = torch.addcmul(c.u, alpha[:, None], dx)
        fx = res(x)
        ls_state = lsr.rnm_post_step_batched(ls_cfg, ls_state, fx)
        s = x - c.u
        y = fx - c.fu
        denom = _dot(s, y)
        sig = _dot(s, s) / torch.where(denom == 0, torch.ones_like(denom),
                                       denom)
        fallback = torch.clamp(1.0 / _l2(fx), 1.0, 1e5)
        ok = ((alg.sigma_min <= sig.abs()) & (sig.abs() <= alg.sigma_max)
              & (denom != 0) & torch.isfinite(sig))
        sigma_new = torch.where(ok, sig, fallback)
        return x, fx, (sigma_new, ls_state), nf_ls + 1, 0, 0, _no_fail(c)

    return _run_simple(res, term_cfg, abstol, reltol, maxiters, x0,
                       (sigma0, ls_state0), step)


def run_simple_trust_region(alg: SimpleTrustRegion, res, term_cfg, x0,
                            abstol, reltol, maxiters):
    """The dogleg trust region with the simple scheme's radius updates, or
    the NLSolve.jl rule (``nlsolve_update_rule``)."""
    nur = bool(alg.nlsolve_update_rule)
    eta2 = (0.05 if nur else 0.25) if alg.shrink_threshold is None \
        else alg.shrink_threshold
    eta3 = (0.9 if nur else 0.75) if alg.expand_threshold is None \
        else alg.expand_threshold
    t1 = (0.5 if nur else 0.25) if alg.shrink_factor is None \
        else alg.shrink_factor
    t2 = alg.expand_factor
    eps = torch.finfo(x0.dtype).eps
    fx0 = res(x0)
    fnorm0 = _l2(fx0)
    if alg.max_trust_radius is None:
        mtr = ordering.maximum(fnorm0, ordering.amax(x0, -1)
                               - ordering.amin(x0, -1))
    else:
        mtr = torch.full_like(fnorm0, alg.max_trust_radius)
    if alg.initial_trust_radius is not None:
        tr0 = torch.full_like(fnorm0, alg.initial_trust_radius)
    elif nur:
        norm_x0 = _l2(x0)
        tr0 = torch.where(norm_x0 > 0, norm_x0, torch.ones_like(norm_x0))
    else:
        tr0 = mtr / 11.0

    def nz(x, fill=1.0):
        return torch.where(x == 0, fill, x)

    def step(c, active):
        tr, shrink_counter = c.extra
        J = res.jac(c.u)
        g = _mv(J.mT, c.fu)
        dx_newton, ok = solve_dense_batched(J, c.fu)
        dx_newton = -dx_newton
        dx_cauchy = -g
        l_grad = _l2(dx_cauchy)
        Jg = _mv(J, dx_cauchy)
        d_cauchy = ipow(l_grad, 3) / nz(_dot(Jg, Jg))
        newton_inside = ordering.less(_l2(dx_newton), tr, or_equal=True)
        lam = tr / nz(l_grad)
        du1 = (d_cauchy / nz(l_grad))[:, None] * dx_cauchy
        du2 = dx_newton - du1
        a = _dot(du2, du2)
        b = 2.0 * _dot(du1, du2)
        cc = ipow(d_cauchy, 2) - ipow(tr, 2)
        aux = b * b - 4.0 * a * cc
        aux = (ordering.maximum(aux, 0.0) if aux.is_complex()
               else torch.clamp(aux, min=0.0))
        tau = (-b + torch.sqrt(aux)) / torch.where(a == 0, 1.0, 2.0 * a)
        dx = torch.where(
            newton_inside[:, None], dx_newton,
            torch.where(ordering.greater(d_cauchy, tr, or_equal=True)[:, None],
                        lam[:, None] * dx_cauchy,
                        du1 + tau[:, None] * du2))
        x_cand = c.u + dx
        fx_cand = res(x_cand)
        Jdx = _mv(J, dx)
        pred = -(_dot(g, dx) + 0.5 * _dot(Jdx, Jdx))
        act = 0.5 * (ipow(_l2(c.fu), 2) - ipow(_l2(fx_cand), 2))
        rho = act / nz(pred, eps)
        accept = ordering.greater(rho, alg.step_threshold,
                                  or_equal=True)[:, None]
        shrink = ordering.less(rho, eta2)
        expand = ordering.greater(rho, eta3)
        x = torch.where(accept, x_cand, c.u)
        fx = torch.where(accept, fx_cand, c.fu)
        if nur:
            dlen = t2 * _l2(dx)
            tr_new = torch.where(shrink, tr * t1, tr)
            tr_new = torch.where(
                expand, dlen,
                torch.where(ordering.greater(rho, 0.5),
                            ordering.maximum(tr_new, dlen), tr_new))
        else:
            tr_new = torch.where(shrink, tr * t1,
                                 torch.where(expand, tr * t2, tr))
            tr_new = ordering.minimum(tr_new, mtr)
        shrink_counter = torch.where(shrink, shrink_counter + 1,
                                     torch.zeros_like(shrink_counter))
        fail = (shrink_counter > alg.max_shrink_times) | ~ok
        return x, fx, (tr_new, shrink_counter), 1, 1, 1, fail

    return _run_simple(res, term_cfg, abstol, reltol, maxiters, x0,
                       (tr0, torch.zeros_like(tr0, dtype=torch.int32)), step)


def run_simple_lbroyden(alg: SimpleLimitedMemoryBroyden, res, term_cfg, x0,
                        abstol, reltol, maxiters):
    """The inverse ≈ (-αI + UᵀV) with an η-deep history ring of
    (η, n) per row; at n ≤ threshold SimpleBroyden, as in the JAX
    package."""
    B, n = x0.shape
    if n <= alg.threshold:
        return run_simple_broyden(
            SimpleBroyden(linesearch=alg.linesearch, alpha=alg.alpha), res,
            term_cfg, x0, abstol, reltol, maxiters)
    eta = alg.threshold
    fx0 = res(x0)
    alpha = _init_alpha(alg.alpha, x0, fx0)[:, None]
    ring = torch.arange(eta, device=x0.device)
    U0 = torch.zeros(B, eta, n, dtype=x0.dtype, device=x0.device)

    def masked(W, nhist):
        return W * (ring[None, :] < nhist[:, None])[:, :, None].to(W.dtype)

    def matvec(U, V, nhist, v):
        Um, Vm = masked(U, nhist), masked(V, nhist)
        return _mv(Um.mT, _mv(Vm, v)) - alpha * v

    def rmatvec(U, V, nhist, v):
        Um, Vm = masked(U, nhist), masked(V, nhist)
        return _mv(Vm.mT, _mv(Um, v)) - alpha * v

    ls_cfg = lsr.LiFukushimaLineSearch() if alg.linesearch else None

    def step(c, active):
        U, V, fo, dx = c.extra
        i = c.nsteps
        if ls_cfg is not None:
            alpha_s, _, nf_ls = lsr.li_fukushima_batched(
                ls_cfg, res, c.u, dx, fo, c.nsteps, active)
        else:
            alpha_s, nf_ls = torch.ones_like(dx[:, 0]), 0
        x = torch.addcmul(c.u, alpha_s[:, None], dx)
        fx = res(x)
        df = fx - fo
        s = alpha_s[:, None] * dx
        vT = rmatvec(U, V, i, s)
        mvec = matvec(U, V, i, df)
        d = _dot(vT, df)
        d = torch.where(d == 0, 1e-5, d)
        dx_upd = (s - mvec) / d[:, None]
        at_slot = (ring[None, :] == torch.remainder(i, eta)[:, None])[
            :, :, None]
        U = torch.where(at_slot, dx_upd[:, None, :], U)
        V = torch.where(at_slot, vT[:, None, :], V)
        dx_next = -matvec(U, V, i + 1, fx)
        return x, fx, (U, V, fx, dx_next), 1 + nf_ls, 0, 1, _no_fail(c)

    return _run_simple(res, term_cfg, abstol, reltol, maxiters, x0,
                       (U0, U0.clone(), fx0, -fx0), step)


_ENGINES = {SimpleNewtonRaphson: run_simple_newton,
            SimpleBroyden: run_simple_broyden,
            SimpleKlement: run_simple_klement,
            SimpleDFSane: run_simple_dfsane,
            SimpleHalley: run_simple_halley,
            SimpleTrustRegion: run_simple_trust_region,
            SimpleLimitedMemoryBroyden: run_simple_lbroyden}


def run_simple_batched(alg, res: BatchedResidual, term_cfg, x0, abstol,
                       reltol, maxiters: int) -> SimpleCarry:
    """Run ``alg`` on every row of ``x0`` (B, n) in lockstep; the carry's
    retcode and stats are (B,) device tensors."""
    engine = _ENGINES.get(type(alg))
    if engine is None:
        raise ValueError(f"unknown simple algorithm {alg!r}")
    return engine(alg, res, term_cfg, x0, abstol, reltol, maxiters)


@dataclasses.dataclass(frozen=True)
class SimpleResult:
    """A lone simple solve: the engines' common carry fields, on the host
    where they are counts (the simple tier makes no Krylov products)."""

    u: Any
    fu: Any
    retcode: int
    stats: NLStats
    njvp: int = 0
    krylov_iters: int = 0


def run_simple(alg, ctx, term_cfg, analytic_jac, u0, abstol, reltol,
               maxiters: int) -> SimpleResult:
    """One problem on the simple tier: the flattened state as a batch of
    one (the JAX package runs the simple tier on the flattened state too),
    its u and fu back in their own shapes, its retcode and stats read in
    one host sync."""
    shape = u0.shape

    def f1(v, _p):
        return ctx.f_flat(v.reshape(shape)).reshape(-1)

    jac1 = None
    if analytic_jac is not None:
        def jac1(v, _p):
            return analytic_jac(v.reshape(shape)).reshape(ctx.n_out, -1)

    res = BatchedResidual(f1=f1, p=None, pdim=None, n_out=ctx.n_out,
                          jac1=jac1, is_least_squares=ctx.is_least_squares)
    final = run_simple_batched(alg, res, term_cfg, u0.reshape(1, -1),
                               abstol, reltol, maxiters)
    s = final.stats
    host = _backend.fetch(final.retcode, s.nf, s.njacs, s.nfactors,
                          s.nsolve, s.nsteps)
    retcode, *counts = [int(h[0]) for h in host]
    fu = final.fu[0]
    if ctx.out_shape is not None:
        fu = fu.reshape(ctx.out_shape)
    return SimpleResult(u=final.u[0].reshape(shape), fu=fu,
                        retcode=retcode, stats=NLStats(*counts))

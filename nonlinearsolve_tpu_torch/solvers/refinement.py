"""Mixed-precision iterative refinement: double-f32 defect correction
(the port of ``solvers/refinement.py``).

An f32 Newton–Krylov solve stalls at the residual-evaluation noise floor
``O(eps_f32 · max |term|)`` (~3 digits in u on the 512² Brusselator).
Classic iterative refinement lifts that floor without f64 arithmetic in
the solves:

    repeat:  d   = f(u_hi + u_lo)        # defect in double-f32 (~1e-14 rel)
             δ   = solve(J(u_hi), -d)    # f32 GMRES, modest tolerance
             u  += δ                     # double-word accumulation

Each round contracts the error by ~(inner rtol + O(|e|²)); with the
defect in double-f32 the attainable floor is the double-word noise
(~1e-13 relative).  The Jacobian products, the preconditioner and GMRES
stay in f32; only the (bandwidth-bound, elementwise) defect evaluation
pays the double-word cost.  The rounds are a Python loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops.doublef32 import DF, df_add_f
from ..ops.krylov import gmres


class RefineResult(NamedTuple):
    u: DF                     # refined double-word root (hi + lo)
    defect_norm: torch.Tensor  # |f(u)|_inf of the final double-f32 defect
    rounds: int


def _stage_precond(precond_fn, u, fu):
    """The Krylov descent's contract: a factory ``u -> (v -> M⁻¹v)``
    (``wants_residual``: ``(u, fu) ->``), or a plain ``v -> M⁻¹v``
    applier."""
    if precond_fn is None:
        return None
    if getattr(precond_fn, "wants_residual", False):
        M = precond_fn(u, fu)
        if not callable(M):
            raise TypeError(
                "a wants_residual preconditioner factory must return a "
                f"v -> M⁻¹v callable; got {type(M).__name__}")
        return M
    M = precond_fn(u)
    if not callable(M):
        # plain applier: calling it with u returned a tensor
        return precond_fn
    return M


def refine_root(u0,
                residual_df: Callable,
                jvp_at: Callable,
                *,
                vjp_at: Optional[Callable] = None,
                rounds: int = 3,
                inner_rtol: float = 1e-2,
                restart: int = 16,
                krylov_maxiter: int = 100,
                precond_fn: Optional[Callable] = None) -> RefineResult:
    """Refine an f32 root ``u0`` (a tensor of any shape, or a DF) to
    double-f32 accuracy.

    Args:
      residual_df: ``(u_hi, u_lo) -> (f_hi, f_lo)``, the residual in
        double-f32 (``models.brusselator.brusselator_2d_df32``, or
        ``ops.doublef32_eval.df_eval`` of any residual).
      jvp_at: ``u_hi -> (v -> J(u_hi) @ v)``, the f32 Jacobian product at
        a point (a stencil kernel slots in directly).
      vjp_at: optional ``u_hi -> (v -> J(u_hi)ᵀ @ v)``: the residual may
        then be non-square, and each correction solves the Gauss–Newton
        normal equations ``JᵀJ δ = -Jᵀ d`` by GMRES on ``vjp∘jvp``.
      rounds: refinement sweeps.
      inner_rtol / restart / krylov_maxiter / precond_fn: the f32 GMRES
        correction solve (the knobs of ``LinearSolver``).

    Returns a :class:`RefineResult`; the refined root is ``res.u.hi``
    (f32) or ``res.u.hi.double() + res.u.lo``.
    """
    u = u0 if isinstance(u0, DF) else DF(u0, torch.zeros_like(u0))
    for _ in range(int(rounds)):
        f_hi, f_lo = residual_df(u.hi, u.lo)
        d = f_hi + f_lo                       # rounding adds only eps·|d|
        jv = jvp_at(u.hi)
        if vjp_at is not None:                # least squares: JᵀJ δ = -Jᵀd
            vj = vjp_at(u.hi)
            mv = lambda v, jv=jv, vj=vj: vj(jv(v))   # noqa: E731
            rhs = -vj(d)
        else:
            mv = jv
            rhs = -d
        M = _stage_precond(precond_fn, u.hi, d)
        res = gmres(mv, rhs, restart=restart, maxiter=krylov_maxiter,
                    rtol=inner_rtol, M=M)
        u = df_add_f(u, res.x)
    f_hi, f_lo = residual_df(u.hi, u.lo)      # final certified defect
    defect = torch.max(torch.abs(f_hi + f_lo))
    return RefineResult(u=u, defect_norm=defect, rounds=int(rounds))


def auto_refine(prob, u, *, p64=None, rounds: int = 3,
                inner_rtol: float = 1e-2, restart: int = 16,
                krylov_maxiter: int = 100,
                precond_fn: Optional[Callable] = None,
                first_order_transcendentals: bool = False) -> RefineResult:
    """One-call refinement of a solved problem: the double-f32 defect
    re-evaluates the problem's residual through the graph interpreter
    (``ops/doublef32_eval.py``), so no hand-written double-word residual
    is needed.

    Args:
      prob: the solved problem (``f(u, p)``; the ``NonlinearFunction``'s
        ``jvp`` serves the correction solves when given, else
        ``torch.func.jvp``; a least-squares problem also takes its ``vjp``
        or ``torch.func.vjp``).
      u: the converged f32 iterate (``sol.u``).
      p64: optional host float64 parameters (a tree of arrays) split
        exactly into double-f32, so parameter rounding does not cap the
        refinement (the f32 ``prob.p`` values are used otherwise, as
        exact).
      rounds / inner_rtol / restart / krylov_maxiter / precond_fn: see
        :func:`refine_root`.

    The residual is traced once (``df_trace``) and its graph evaluated
    at each round.  exp/log/sin/cos/pow residuals evaluate at double-word
    grade;
    tanh/sinh/… raise ``NotImplementedError`` with guidance, or opt into
    the first-order overlay with ``first_order_transcendentals=True``.
    """
    from ..core.problems import NonlinearFunction
    from ..ops.doublef32 import df_from_f64
    from ..ops.doublef32_eval import df_trace, first_order_rules
    from ..utils.pytree import tree_map

    nf = prob.f if isinstance(prob.f, NonlinearFunction) \
        else NonlinearFunction(f=prob.f)
    raw_f = nf.f
    dtype, dev = u.dtype, u.device

    if p64 is not None:
        p_df = tree_map(lambda x: df_from_f64(x, dtype, device=dev), p64)
    elif prob.p is not None:
        def exact(x):
            x = torch.as_tensor(x, device=dev) if not isinstance(
                x, torch.Tensor) else x
            return DF(x, torch.zeros_like(x)) if x.is_floating_point() else x
        p_df = tree_map(exact, prob.p)
    else:
        p_df = None

    rules = first_order_rules() if first_order_transcendentals else None
    # the residual's graph does not depend on u's value: traced once, at
    # u, and evaluated at every round's iterate
    fn, p_args = ((lambda uu: raw_f(uu, None)), ()) if p_df is None \
        else (raw_f, (p_df,))
    graph = df_trace(fn, DF(u, torch.zeros_like(u)), *p_args)

    def residual_df(uh, ul):
        out = graph(DF(uh, ul), *p_args, rules=rules)
        return out.hi, out.lo

    p_for_jvp = prob.p

    def jvp_at(uh):
        if nf.jvp is not None:
            return lambda v: nf.jvp(v, uh, p_for_jvp)
        return lambda v: torch.func.jvp(
            lambda uu: raw_f(uu, p_for_jvp), (uh,), (v,))[1]

    vjp_at = None
    if getattr(prob, "is_least_squares", False):
        def vjp_at(uh):                                  # noqa: F811
            if nf.vjp is not None:
                return lambda v: nf.vjp(v, uh, p_for_jvp)
            _, pull = torch.func.vjp(lambda uu: raw_f(uu, p_for_jvp), uh)
            return lambda v: pull(v)[0]

    return refine_root(u, residual_df, jvp_at, vjp_at=vjp_at,
                       rounds=rounds, inner_rtol=inner_rtol,
                       restart=restart, krylov_maxiter=krylov_maxiter,
                       precond_fn=precond_fn)

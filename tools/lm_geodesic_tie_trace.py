"""The first geodesic accept test of LevenbergMarquardt on u² − p from
u0 = 1, p = 4 (f64), in the JAX package and in the PyTorch port, value by
value, on the CPU.

At that start the test 2‖a‖ ≤ α‖v‖ is a tie in exact arithmetic
(v = 0.75, a = −0.28125, α = 0.75: 0.5625 on both sides), so the last bit
of each intermediate decides the step.  For each side the script prints
one JSON line with the hex of v, u + h·v, f(u + h·v), (f2 − f)/h, J·v, the
right-hand side 2/h·((f2 − f)/h − J·v), a, ‖v‖, ‖a‖, both sides of the
test and its outcome.  The JAX side runs three ways: eagerly, under
``jax.jit`` and inside a one-trip ``lax.while_loop`` (the engine's own
loop); the port runs eagerly.  Each side calls its own package's
``descent_solve`` for v and a, so the two solves are the packages' own.
Last, it runs both packages' ``solve`` and prints their NLStats.

    python3 tools/lm_geodesic_tie_trace.py
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax                                                    # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp                                       # noqa: E402
import torch                                                  # noqa: E402

import nonlinearsolve_tpu as jnls                             # noqa: E402
import nonlinearsolve_tpu_torch as tnls                       # noqa: E402
from nonlinearsolve_tpu.core import descent as jdsc           # noqa: E402
from nonlinearsolve_tpu_torch.core import descent as tdsc     # noqa: E402

U0, P = 1.0, 4.0
NAMES = ("v", "u_plus_hv", "f2", "fd_quotient", "Jv", "rhs", "a",
         "norm_v", "norm_a", "lhs_2norm_a", "rhs_alpha_norm_v")


def _hex(x) -> str:
    return float(x).hex()


def jax_step(u, fu, J):
    """The JAX package's ``_geodesic_solve``, its intermediates kept."""
    alg = jnls.LevenbergMarquardt()
    cfg = alg.descent
    f = lambda x: x * x - P                                   # noqa: E731
    ctx = jdsc.DescentCtx(f_flat=f, n_in=1, n_out=1, is_least_squares=False)
    state = jdsc.descent_init(cfg, ctx, J, fu, u)
    h = cfg.finite_diff_step
    res_v, state = jdsc.descent_solve(cfg.descent, state, ctx, J, fu, u,
                                      recompute_damping=True)
    v = res_v.du
    uh = u + h * v
    fu2 = f(uh)
    fdq = (fu2 - fu) / h
    Jv = J @ v
    rhs = (2.0 / h) * (fdq - Jv)
    res_a, _ = jdsc.descent_solve(cfg.descent, state, ctx, J, rhs, u,
                                  recompute_damping=False)
    a = res_a.du
    nv, na = jnp.linalg.norm(v), jnp.linalg.norm(a)
    return (v[0], uh[0], fu2[0], fdq[0], Jv[0], rhs[0], a[0], nv, na,
            2.0 * na, cfg.alpha * nv)


def torch_step(u, fu, J):
    """The port's ``_geodesic_solve``, its intermediates kept."""
    alg = tnls.LevenbergMarquardt()
    cfg = alg.descent
    f = lambda x: x * x - P                                   # noqa: E731
    ctx = tdsc.DescentCtx(f_flat=f, n_in=1, n_out=1)
    state = tdsc.descent_init(cfg, ctx, J, fu, u)
    h = cfg.finite_diff_step
    res_v, state = tdsc.descent_solve(cfg.descent, state, ctx, J, fu, u,
                                      recompute_damping=True)
    v = res_v.du
    uh = torch.add(u, v, alpha=h)
    fu2 = f(uh)
    fdq = (fu2 - fu) / h
    Jv = J @ v
    rhs = (2.0 / h) * (fdq - Jv)
    res_a, _ = tdsc.descent_solve(cfg.descent, state, ctx, J, rhs, u,
                                  recompute_damping=False)
    a = res_a.du
    nv = torch.linalg.vector_norm(v)
    na = torch.linalg.vector_norm(a)
    return (v[0], uh[0], fu2[0], fdq[0], Jv[0], rhs[0], a[0], nv, na,
            2.0 * na, cfg.alpha * nv)


def _line(side, vals):
    rec = {"side": side, **{k: _hex(x) for k, x in zip(NAMES, vals)}}
    rec["accepted"] = bool(float(vals[-2]) <= float(vals[-1]))
    print(json.dumps(rec))
    return rec


def main() -> int:
    ju = jnp.array([U0])
    jfu, jJ = ju * ju - P, jnp.array([[2.0 * U0]])
    recs = [_line("jax eager", _eager(ju, jfu, jJ)),
            _line("jax jit", jax.jit(jax_step)(ju, jfu, jJ))]

    def body(carry):
        k, _ = carry
        return k + 1, jnp.stack(jax_step(ju, jfu, jJ))
    _, out = jax.jit(lambda: jax.lax.while_loop(
        lambda c: c[0] < 1, body, (0, jnp.zeros(len(NAMES)))))()
    recs.append(_line("jax while_loop", list(out)))
    tu = torch.tensor([U0], dtype=torch.float64)
    recs.append(_line("torch", torch_step(tu, tu * tu - P,
                                          torch.tensor([[2.0 * U0]],
                                                       dtype=torch.float64))))
    parts = {k: sorted({r[k] for r in recs}) for k in NAMES}
    print(json.dumps({"values_that_part": {k: v for k, v in parts.items()
                                           if len(v) > 1}}))
    jsol = jnls.solve(jnls.NonlinearProblem(lambda u, p: u * u - p,
                                            jnp.array([U0]), P),
                      jnls.LevenbergMarquardt())
    tsol = tnls.solve(tnls.NonlinearProblem(lambda u, p: u * u - p,
                                            torch.tensor([U0],
                                                         dtype=torch.float64),
                                            P),
                      tnls.LevenbergMarquardt())
    print(json.dumps({"solve": {
        "jax": {k: int(getattr(jsol.stats, k)) for k in
                ("nf", "njacs", "nfactors", "nsolve", "nsteps")},
        "torch": {k: int(getattr(tsol.stats, k)) for k in
                  ("nf", "njacs", "nfactors", "nsolve", "nsteps")}}}))
    return 0


def _eager(u, fu, J):
    with jax.disable_jit():
        return jax_step(u, fu, J)


if __name__ == "__main__":
    sys.exit(main())

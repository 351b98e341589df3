"""The JAX package's double-f32 refinement outcomes that
``tests/test_torch_refinement.py`` holds the PyTorch port to, where a live
JAX run would cost the test budget (``tests/test_refinement.py``'s
``TestRefineRoot`` flagship case, about 11 s, and its Bratu anchor, about
14 s, on a CPU).  Runs on the CPU in f64 and prints one JSON line a case:

- ``flagship``: the N = 16 Brusselator solved in f32 (NewtonRaphson,
  GMRES(16), the FFT preconditioner, η = 1e-2, abstol 0.05), refined by
  ``refine_root`` with ``brusselator_2d_df32`` (3 rounds, inner rtol
  1e-2), against the f64 solve (abstol 1e-8);
- ``bratu``: Bratu 32² solved in f32 (NewtonRaphson, GMRES(32), abstol
  1e-3), refined by ``auto_refine`` (4 rounds), against the f64 solve
  (abstol 1e-12).

Each line carries the f32 solve's retcode and NLStats [nf, njacs,
nfactors, nsolve, nsteps], the rel-inf distance of the fast and of the
refined root to the f64 root, the final defect, and checksums of the
refined root (its sum, its max and its dot with a seeded normal vector,
numpy seed 7) in f64.

    python tools/refinement_reference.py
"""

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import nonlinearsolve_tpu as nls  # noqa: E402
from nonlinearsolve_tpu.models import bratu, brusselator  # noqa: E402
from nonlinearsolve_tpu.ops import doublef32 as dfm  # noqa: E402
from nonlinearsolve_tpu.ops.preconditioners import \
    fft_poisson_preconditioner  # noqa: E402
from nonlinearsolve_tpu.solvers.first_order import \
    EisenstatWalkerForcing  # noqa: E402


def stats(sol):
    s = sol.stats
    return [int(s.nf), int(s.njacs), int(s.nfactors), int(s.nsolve),
            int(s.nsteps)]


def checksums(u):
    u = np.asarray(u, np.float64).reshape(-1)
    w = np.random.default_rng(7).standard_normal(u.size)
    return [float(u.sum()), float(u.max()), float(u @ w)]


def line(case, sol32, u_ref, u64, defect):
    u64 = np.asarray(u64, np.float64)
    scale = float(np.abs(u64).max())
    return {"case": case, "retcode": int(sol32.retcode),
            "stats": stats(sol32),
            "fast_rel": float(np.abs(np.asarray(sol32.u, np.float64)
                                     - u64).max()) / scale,
            "refined_rel": float(np.abs(u_ref - u64).max()) / scale,
            "defect": float(defect), "checksums": checksums(u_ref)}


def flagship():
    N = 16
    pm = fft_poisson_preconditioner((N, N), alpha=10.0, h=1.0 / (N - 1),
                                    shift=3.0, n_components=2)
    alg = nls.NewtonRaphson(
        linsolve=nls.LinearSolver(method="gmres", restart=16,
                                  krylov_maxiter=100, precond_fn=pm),
        forcing=EisenstatWalkerForcing(eta_0=1e-2, eta_max=1e-2))
    sol32 = nls.solve(brusselator.make_problem(N, jnp.float32), alg,
                      abstol=0.05, maxiters=30)
    pm64 = fft_poisson_preconditioner((N, N), alpha=10.0, h=1.0 / (N - 1),
                                      shift=3.0, n_components=2)
    alg64 = nls.NewtonRaphson(
        linsolve=nls.LinearSolver(method="gmres", restart=16,
                                  krylov_maxiter=200, precond_fn=pm64),
        forcing=EisenstatWalkerForcing(eta_0=1e-4, eta_max=1e-4))
    sol64 = nls.solve(brusselator.make_problem(N, jnp.float64), alg64,
                      abstol=1e-8, maxiters=50)
    p64 = brusselator.default_p(N, jnp.float64)
    p32 = brusselator.default_p(N, jnp.float32)

    def jvp_at(uh):
        return lambda v: jax.jvp(lambda U: brusselator.brusselator_2d(U, p32),
                                 (uh,), (v,))[1]

    res = nls.refine_root(
        sol32.u, lambda uh, ul: brusselator.brusselator_2d_df32(uh, ul, p64),
        jvp_at, rounds=3, inner_rtol=1e-2, restart=16, precond_fn=pm)
    out = line("flagship", sol32, dfm.df_value_f64(res.u), sol64.u,
               res.defect_norm)
    out["f64_stats"] = stats(sol64)
    return out


def bratu_anchor():
    N = 32
    alg = nls.NewtonRaphson(linsolve=nls.LinearSolver(method="gmres",
                                                      restart=32))
    prob32 = bratu.make_problem(N, dtype=jnp.float32)
    sol = nls.solve(prob32, alg, abstol=1e-3, maxiters=50)
    res = nls.auto_refine(prob32, sol.u, rounds=4)
    sol64 = nls.solve(bratu.make_problem(N, dtype=jnp.float64),
                      nls.NewtonRaphson(), abstol=1e-12, maxiters=100)
    out = line("bratu", sol, dfm.df_value_f64(res.u), sol64.u,
               res.defect_norm)
    out["f64_stats"] = stats(sol64)
    return out


if __name__ == "__main__":
    for case in (flagship, bratu_anchor):
        print(json.dumps(case()), flush=True)

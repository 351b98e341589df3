"""The JAX package's outcomes at the points that ``chip_smoke.py`` phase 24
holds the PyTorch port to: the Bratu λ-continuation (λ from 0 to 6.5,
u0 = 0, abstol 1e-8) at N = 32 and 64 under the sweep, Kantorovich and
arclength methods with a NewtonRaphson inner and the default
HomotopyPolyAlgorithm; the three methods at N = 32 at the default abstol
(``_floor``); and DynamicSS on Bratu 32² at λ = 3.5.  Runs on the
CPU in f64 and prints one JSON line a case (retcode, nf / njacs / nsteps,
the last λ, max u and Σu of the root, |H|∞ at λ = 6.5).

    python tools/homotopy_reference.py            # every case
    python tools/homotopy_reference.py 32 sweep   # one size, one method

N = 64 takes 9–81 s a method on a CPU (a dense 4096² Jacobian and LU a
Newton step).
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import nonlinearsolve_tpu as nls  # noqa: E402
from nonlinearsolve_tpu.models.bratu import bratu_2d  # noqa: E402

METHODS = {
    "sweep": lambda: nls.HomotopySweep(inner=nls.NewtonRaphson()),
    "kantorovich": lambda: nls.KantorovichHomotopy(
        inner=nls.NewtonRaphson()),
    "arclength": lambda: nls.ArcLengthContinuation(
        inner=nls.NewtonRaphson()),
    "polyalg": lambda: nls.HomotopyPolyAlgorithm(),
}


def H(u, p, lam):
    return bratu_2d(u, lam)


def stats(sol):
    s = sol.stats
    return [int(s.nf), int(s.njacs), int(s.nsteps)]


def homotopy_case(N, name, floor=False):
    prob = nls.HomotopyProblem(H, jnp.zeros((N, N)), None,
                               lambdaspan=(0.0, 6.5))
    t0 = time.time()
    sol = nls.solve(prob, METHODS[name](), **({} if floor
                                              else {"abstol": 1e-8}))
    u = np.asarray(sol.u)
    return {"case": f"bratu{N}_{name}" + ("_floor" if floor else ""),
            "retcode": int(sol.retcode),
            "stats": stats(sol), "lam_last": float(sol.original),
            "max_u": float(u.max()), "sum_u": float(u.sum()),
            "resid_inf": float(np.abs(np.asarray(bratu_2d(sol.u, 6.5))).max()),
            "seconds": time.time() - t0}


def dynamic_ss_case(method):
    prob = nls.SteadyStateProblem(bratu_2d, jnp.zeros((32, 32)),
                                  jnp.asarray(3.5))
    t0 = time.time()
    sol = nls.solve(prob, nls.DynamicSS(method=method))
    return {"case": f"dynamic_ss_{method}", "retcode": int(sol.retcode),
            "stats": stats(sol), "max_u": float(np.asarray(sol.u).max()),
            "seconds": time.time() - t0}


def main(argv):
    sizes = [int(argv[0])] if argv else [32, 64]
    names = [argv[1]] if len(argv) > 1 else list(METHODS)
    for N in sizes:
        for name in names:
            print(json.dumps(homotopy_case(N, name)), flush=True)
    if not argv:
        for name in ("sweep", "kantorovich", "arclength"):
            print(json.dumps(homotopy_case(32, name, floor=True)),
                  flush=True)
        for method in ("rosenbrock23", "tsit5"):
            print(json.dumps(dynamic_ss_case(method)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

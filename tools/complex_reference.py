"""The JAX package's outcomes at the complex-state points that
``chip_smoke.py`` phases 25 and 26 hold the PyTorch port to: u³ − 8
from −0.8 + 1.5i (complex128) under NewtonRaphson, Broyden, Klement and
the default ladder (phase 25) and under the engines that order values
(phase 26: LevenbergMarquardt, TrustRegion, AndersonAcceleration,
SimpleTrustRegion — with the analytic Jacobian, as the JAX simple tier's
jacfwd refuses complex inputs — SimpleDFSane, and RobustMultiNewton and
PseudoTransient, which fail to trace: their line carries the error);
``tests/test_core_solvers.py``'s complex least-squares fit under
GaussNewton; and the N = 32 Brusselator (2048 unknowns, abstol 1e-10,
NewtonRaphson, and TrustRegion for phase 26) on a complex128 state
started at ``init_u0`` plus 1e-3·i times a seeded standard-normal field
(numpy seed 0), beside the real f64 solve.  Runs on the CPU in f64 and
prints one JSON line a case (retcode, NLStats [nf, njacs, nfactors,
nsolve, nsteps], and for the Brusselator max|Im u| and
max|Re u − u_real|).

    python tools/complex_reference.py

The JAX Brusselator builds its forcing mask in the state's dtype, which
for a complex state orders complex numbers; the residual here takes the
mask of the real grid, as the port's model does for a complex state.
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
from nonlinearsolve_tpu.models import brusselator  # noqa: E402


def stats(sol):
    s = sol.stats
    return [int(s.nf), int(s.njacs), int(s.nfactors), int(s.nsolve),
            int(s.nsteps)]


def complex_brusselator(N):
    """``brusselator_2d`` with the forcing mask of the real grid."""
    xy = jnp.linspace(0.0, 1.0, N, dtype=jnp.float64)
    x, y = xy[:, None], xy[None, :]
    force = 5.0 * (((x - 0.3) ** 2 + (y - 0.6) ** 2) <= 0.01).astype(
        jnp.float64)

    def f(U, p):
        A, B, alpha, dx = p[0], p[1], p[2], p[3]
        alpha = alpha / dx ** 2
        u, v = U[..., 0], U[..., 1]

        def lap(w):
            return (jnp.roll(w, 1, 0) + jnp.roll(w, -1, 0)
                    + jnp.roll(w, 1, 1) + jnp.roll(w, -1, 1) - 4.0 * w)
        du = alpha * lap(u) + B + u * u * v - (A + 1.0) * u + \
            force.astype(U.dtype)
        dv = alpha * lap(v) + A * u - u * u * v
        return jnp.stack([du, dv], axis=-1)
    return f


def main():
    prob = nls.NonlinearProblem(lambda u, p: u ** 3 - p,
                                jnp.array([-0.8 + 1.5j], jnp.complex128),
                                8.0 + 0j)
    for name in ("NewtonRaphson", "Broyden", "Klement", "default"):
        sol = nls.solve(prob, None if name == "default"
                        else getattr(nls, name)())
        print(json.dumps({"case": "cubic", "alg": name,
                          "retcode": int(sol.retcode), "stats": stats(sol),
                          "u": [complex(sol.u[0]).real,
                                complex(sol.u[0]).imag]}), flush=True)
    jac = nls.NonlinearFunction(f=lambda u, p: u ** 3 - p,
                                jac=lambda u, p: jnp.diag(3 * u ** 2))
    for name in ("LevenbergMarquardt", "TrustRegion", "AndersonAcceleration",
                 "SimpleTrustRegion", "SimpleDFSane", "RobustMultiNewton",
                 "PseudoTransient"):
        line = {"case": "cubic", "alg": name}
        try:
            sol = nls.solve(prob.remake(f=jac) if name == "SimpleTrustRegion"
                            else prob, getattr(nls, name)())
            line.update(retcode=int(sol.retcode), stats=stats(sol),
                        u=[complex(sol.u[0]).real, complex(sol.u[0]).imag])
        except TypeError as e:
            line["error"] = str(e).splitlines()[0]
        print(json.dumps(line), flush=True)
    ts = jnp.linspace(0.0, 1.0, 8)
    e = jnp.exp(1j * 2 * jnp.pi * ts)
    sol = nls.solve(nls.NonlinearLeastSquaresProblem(
        lambda u, p: u[0] * e - p, jnp.array([0.5 + 0.1j], jnp.complex128),
        (2.0 + 1.0j) * e), nls.GaussNewton())
    print(json.dumps({"case": "complex_nlls", "retcode": int(sol.retcode),
                      "stats": stats(sol),
                      "u": [complex(sol.u[0]).real,
                            complex(sol.u[0]).imag]}), flush=True)
    N = 32
    u0 = np.asarray(brusselator.init_u0(N))
    pert = np.random.default_rng(0).standard_normal(u0.shape)
    p = brusselator.default_p(N)
    for alg in ("NewtonRaphson", "TrustRegion"):
        t0 = time.time()
        real = nls.solve(nls.NonlinearProblem(brusselator.brusselator_2d,
                                              jnp.asarray(u0), p),
                         getattr(nls, alg)(), abstol=1e-10)
        cplx = nls.solve(nls.NonlinearProblem(
            complex_brusselator(N), jnp.asarray(u0 + 1e-3j * pert), p),
            getattr(nls, alg)(), abstol=1e-10)
        print(json.dumps({
            "case": "complex_brusselator", "N": N, "alg": alg,
            "real_retcode": int(real.retcode), "real_stats": stats(real),
            "retcode": int(cplx.retcode), "stats": stats(cplx),
            "max_imag": float(jnp.abs(cplx.u.imag).max()),
            "max_real_gap": float(jnp.abs(cplx.u.real - real.u).max()),
            "seconds": time.time() - t0}), flush=True)


if __name__ == "__main__":
    main()

"""The Bratu λ-continuation of ``test_torch_homotopy_bratu.py`` at the
default abstol, f64 on the CPU, against the JAX package.

At ε^(4/5) = 3e-13 the h⁻²-scaled residual sits on its rounding floor,
and every method ends in ``MaxIters`` near λ 3 and max u ≈ 0.27, in both
packages: the JAX package's outcome, which the port reproduces and does
not fix.  Whether an inner solve stops one Newton step sooner depends on
how the residual rounds at the floor, so the counts part (ROADMAP C).
Measured (port / JAX package, the sweep): the first continuation step
takes 12 / 13 residuals and gives the same λ and a root within 7e-15;
the whole run 409 / 312 Newton steps (375 with two LAPACK threads), λ
2.96 / 3.017, max u 0.266 / 0.2717.  So this file co-iterates the first
step with the JAX package (λ equal, roots within 1e-12) and holds the
whole sweep to the JAX package's ``MaxIters``, the λ it stops at within
0.1 and its max u within 0.01 (``JAX_FLOOR_SWEEP``, from
``tools/homotopy_reference.py``).  Kantorovich and arclength run whole at
the default abstol on the card (``chip_smoke.py`` phase 24 (a)).
"""

import jax.numpy as jnp
import numpy as np
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models.bratu import bratu_2d as jbratu
from nonlinearsolve_tpu_torch.models.bratu import bratu_2d as tbratu

torch.set_num_threads(1)

N = 32
# retcode, nf / njacs / nsteps, the last λ, max u
JAX_FLOOR_SWEEP = ("MaxIters", [392, 312, 312], 3.0172801375389096,
                   0.2717039741383961)


def H_j(u, p, lam):
    return jbratu(u, lam)


def H_t(u, p, lam):
    return tbratu(u, lam)


def sweep(m, **kw):
    return m.HomotopySweep(inner=m.NewtonRaphson(), **kw)


def port_problem():
    return tnls.HomotopyProblem(H_t, torch.zeros((N, N), dtype=torch.float64),
                                None, lambdaspan=(0.0, 6.5))


def test_bratu32_floor_coiterates():
    """The first continuation step: the JAX package's λ and root."""
    jsol = jnls.solve(jnls.HomotopyProblem(H_j, jnp.zeros((N, N)), None,
                                           lambdaspan=(0.0, 6.5)),
                      sweep(jnls, maxsteps=1))
    tsol = tnls.solve(port_problem(), sweep(tnls, maxsteps=1))
    assert int(tsol.retcode) == int(jsol.retcode) == int(
        tnls.ReturnCode.MaxIters)
    assert float(tsol.original) == float(jsol.original)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-12)


def test_bratu32_floor_sweep_maxiters():
    """The whole sweep: the JAX package's ``MaxIters`` near its λ and
    max u."""
    code, _stats, lam_last, max_u = JAX_FLOOR_SWEEP
    sol = tnls.solve(port_problem(), sweep(tnls))
    assert sol.retcode.name == code
    assert abs(float(sol.original) - lam_last) <= 0.1
    assert abs(float(sol.u.max()) - max_u) <= 0.01
    assert torch.isfinite(sol.u).all()

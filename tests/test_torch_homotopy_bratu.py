"""The Bratu λ-continuation against the JAX package, f64 on the CPU:
``H(u, p, λ) = bratu_2d(u, λ)``, u0 = 0, λ from 0 to 6.5 (the fold is at
λ* ≈ 6.808).

``test_bratu_continuation_live`` runs both packages on the same problem
at N = 8 and 16, at the default abstol and at 1e-8: the sweep,
Kantorovich and arclength with a NewtonRaphson inner, and at N = 16,
abstol 1e-8, the default ``HomotopyPolyAlgorithm`` (its FastShortcut
inner, about 12 s of JAX compile).  The port holds the JAX package's
retcode, NLStats and last λ, and a root within 1e-10.

On BASELINE config 3's 32² grid, at ``abstol=1e-8``, every method
succeeds, with the JAX package's retcode, NLStats and last λ, and a root
whose max and sum agree with its to 1e-10 and 1e-9 (``JAX_BRATU32``: the
JAX package's outcomes as ``tools/homotopy_reference.py`` prints them; a
dense 1024² Jacobian and LU a Newton step in each package would make a
live comparison at this size the costliest in the test run, under its
parallel load).  ``test_torch_homotopy_bratu_floor.py`` holds the
default abstol at N = 32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models.bratu import bratu_2d as jbratu
from nonlinearsolve_tpu_torch.models.bratu import bratu_2d

torch.set_num_threads(1)

N = 32
LAMBDASPAN = (0.0, 6.5)
# retcode Success; nf / njacs / nsteps, the last λ, max u, Σu
JAX_BRATU32 = {
    "HomotopySweep": ([26, 14, 14], 6.5, 1.0023877091495275,
                      473.80664871755164),
    "KantorovichHomotopy": ([19, 11, 11], 6.5, 1.002387709170672,
                            473.806648725844),
    "ArcLengthContinuation": ([86, 62, 62], 6.6349508758050675,
                              1.0023877091707218, 473.8066487258636),
    "HomotopyPolyAlgorithm": ([50, 13, 34], 6.5, 1.0023877091495275,
                              473.80664871755164),
}


STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")
# (N, abstol or None for the default, method); the polyalgorithm runs once
LIVE = [(n, tol, name) for n in (8, 16) for tol in (None, 1e-8)
        for name in ("HomotopySweep", "KantorovichHomotopy",
                     "ArcLengthContinuation")]
LIVE.append((16, 1e-8, "HomotopyPolyAlgorithm"))


def H(u, p, lam):
    return bratu_2d(u, lam)


def H_j(u, p, lam):
    return jbratu(u, lam)


def algorithm(m, name):
    return (m.HomotopyPolyAlgorithm() if name == "HomotopyPolyAlgorithm"
            else getattr(m, name)(inner=m.NewtonRaphson()))


@pytest.mark.parametrize("n,abstol,name", LIVE)
def test_bratu_continuation_live(n, abstol, name):
    kw = {} if abstol is None else {"abstol": abstol}
    jsol = jnls.solve(jnls.HomotopyProblem(H_j, jnp.zeros((n, n)), None,
                                           lambdaspan=LAMBDASPAN),
                      algorithm(jnls, name), **kw)
    tsol = tnls.solve(tnls.HomotopyProblem(
        H, torch.zeros((n, n), dtype=torch.float64), None,
        lambdaspan=LAMBDASPAN), algorithm(tnls, name), **kw)
    assert int(tsol.retcode) == int(jsol.retcode) == int(
        tnls.ReturnCode.Success)
    assert ([int(getattr(tsol.stats, k)) for k in STATS]
            == [int(getattr(jsol.stats, k)) for k in STATS])
    assert float(tsol.original) == float(jsol.original)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-10)


def problem():
    return tnls.HomotopyProblem(H, torch.zeros((N, N), dtype=torch.float64),
                                None, lambdaspan=LAMBDASPAN)


@pytest.mark.parametrize("name", list(JAX_BRATU32))
def test_bratu32_continuation(name):
    sol = tnls.solve(problem(), algorithm(tnls, name), abstol=1e-8)
    stats, lam_last, max_u, sum_u = JAX_BRATU32[name]
    assert sol.retcode == tnls.ReturnCode.Success
    assert [sol.stats.nf, sol.stats.njacs, sol.stats.nsteps] == stats
    assert float(sol.original) == lam_last
    assert abs(float(sol.u.max()) - max_u) <= 1e-10
    assert abs(float(sol.u.sum()) - sum_u) <= 1e-9
    assert float(bratu_2d(sol.u, 6.5).abs().max()) <= 1e-8

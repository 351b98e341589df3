"""ROADMAP C.3 and C.4 against the JAX package, f64 on the CPU.

C.3, NaN in a bracket: the bracketing methods compare signs with
``jnp.sign`` semantics (NaN stays NaN), so a NaN residual at a point takes
the JAX package's branch.  Two cases: ``log(u) − 0.5`` on (−1, 3), NaN at
the left end, and ``u − p`` on (0, 1) over p = [0.3, NaN, 0, 1, 2] (the
NaN row), each method lone and as one batch; every port solve gives the
JAX package's lone retcode and nf, and u bit for bit on the first case
and within 4 ulps on the second (NaN where it returns NaN: Muller's row
p = 0.3 ends 4 ulps apart, the two packages' Muller steps rounding
otherwise, ``tests/test_torch_bracketing.py``), and a batch row is its
lone solve bit for bit.

C.4, a singular Jacobian under the implicit-function rule: r = u² − p
with p = [−1, 2], u0 = [1, 1.5], maxiters 30 ends MaxIters at u = [0, …],
where ∂r/∂u is singular.  ``jax.grad`` of Σu gives [NaN, NaN]; the port's
reverse and forward modes give NaN and raise nothing.  (The JAX package's
forward mode gives [inf, NaN]: its LU divides by the zero pivot where the
port's ``solve_ex`` reports it; both are non-finite.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.solvers import bracketing as jbrk
from nonlinearsolve_tpu_torch.solvers import bracketing as tbrk

torch.set_num_threads(1)

F64 = torch.float64
NAMES = ["Bisection", "Falsi", "Ridder", "Brent", "ITP", "Alefeld", "Muller",
         "ModAB"]
P_ROWS = [0.3, float("nan"), 0.0, 1.0, 2.0]
ULPS = 4        # tests/test_torch_bracketing.py's bound on a root


def _same_float(a, b, ulps=0):
    """Both NaN, or within ``ulps`` units in the last place."""
    a, b = np.float64(float(a)), np.float64(float(b))
    if np.isnan(a) or np.isnan(b):
        return bool(np.isnan(a) and np.isnan(b))
    return abs(int(a.view(np.int64)) - int(b.view(np.int64))) <= ulps


def _t(x):
    return torch.tensor(x, dtype=F64)


@pytest.mark.parametrize("name", NAMES)
def test_nan_at_the_left_end(name):
    """log(u) − 0.5 on (−1, 3): NaN at the left end (the JAX package's
    Bisection, Falsi and ModAB return u = −0.99999999999977, Alefeld and
    Ridder end MaxIters at −1.0 / NaN)."""
    jsol = jnls.solve(jnls.IntervalNonlinearProblem(
        lambda u, p: jnp.log(u) - 0.5, (-1.0, 3.0)), getattr(jbrk, name)())
    tsol = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, p: torch.log(u) - 0.5, (_t(-1.0), _t(3.0))),
        getattr(tbrk, name)())
    assert (int(tsol.retcode), tsol.stats.nf, tsol.stats.nsteps) == \
        (int(jsol.retcode), int(jsol.stats.nf), int(jsol.stats.nsteps))
    assert _same_float(tsol.u, jsol.u), (float(tsol.u), float(jsol.u))
    # the same bracket twice in one batch: each row is the lone solve
    bsol = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, p: torch.log(u) - 0.5,
        (_t([-1.0, -1.0]), _t([3.0, 3.0]))), getattr(tbrk, name)())
    for i in range(2):
        assert int(bsol.retcode[i]) == int(tsol.retcode)
        assert int(bsol.stats.nf[i]) == tsol.stats.nf
        assert _same_float(bsol.u[i], tsol.u)


@pytest.mark.parametrize("name", NAMES)
def test_nan_parameter_row(name):
    """u − p on (0, 1) over p = [0.3, NaN, 0, 1, 2]: on the NaN row the
    JAX package's Bisection, Falsi, Brent and ModAB return Success,
    Ridder, ITP and Alefeld MaxIters (the port returned InitialFailure
    before the repair)."""
    batch = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, p: u - p, (torch.zeros(5, dtype=F64),
                             torch.ones(5, dtype=F64)), _t(P_ROWS)),
        getattr(tbrk, name)())
    for i, p in enumerate(P_ROWS):
        jsol = jnls.solve(jnls.IntervalNonlinearProblem(
            lambda u, q: u - q, (0.0, 1.0), jnp.float64(p)),
            getattr(jbrk, name)())
        lone = tnls.solve(tnls.IntervalNonlinearProblem(
            lambda u, q: u - q, (_t(0.0), _t(1.0)), _t(p)),
            getattr(tbrk, name)())
        assert (int(lone.retcode), lone.stats.nf) == \
            (int(jsol.retcode), int(jsol.stats.nf)), (p, int(lone.retcode))
        assert _same_float(lone.u, jsol.u, ULPS), (p, float(lone.u),
                                                   float(jsol.u))
        assert (int(batch.retcode[i]), int(batch.stats.nf[i])) == \
            (int(lone.retcode), lone.stats.nf)
        assert _same_float(batch.u[i], lone.u)
    if name in ("Bisection", "Falsi", "Brent", "ModAB"):
        assert int(batch.retcode[1]) == int(tnls.ReturnCode.Success)


def _jax_loss(p):
    prob = jnls.NonlinearProblem(lambda u, q: u * u - q,
                                 jnp.array([1.0, 1.5]), p)
    return jnp.sum(jnls.solve(prob, jnls.NewtonRaphson(), maxiters=30).u)


@pytest.mark.parametrize("name", ["NewtonRaphson", "SimpleNewtonRaphson"])
def test_singular_jacobian_gradient_is_nan(name):
    p0 = np.array([-1.0, 2.0])
    jgrad = np.asarray(jax.grad(_jax_loss)(jnp.asarray(p0)))
    assert np.isnan(jgrad).all()
    jfwd = np.asarray(jax.jacfwd(_jax_loss)(jnp.asarray(p0)))
    assert not np.isfinite(jfwd).any()

    def tprob(p):
        return tnls.NonlinearProblem(lambda u, q: u * u - q,
                                     _t([1.0, 1.5]), p)
    p = _t(p0).requires_grad_(True)
    sol = tnls.solve(tprob(p), getattr(tnls, name)(), maxiters=30)
    assert sol.retcode == tnls.ReturnCode.MaxIters
    assert float(sol.u[0].detach()) == 0.0
    (grad,) = torch.autograd.grad(sol.u.sum(), p)
    np.testing.assert_array_equal(np.isnan(grad.numpy()), np.isnan(jgrad))
    for k in range(2):
        with forward_ad.dual_level():
            tangent = torch.zeros(2, dtype=F64)
            tangent[k] = 1.0
            pd = forward_ad.make_dual(_t(p0), tangent)
            sol = tnls.solve(tprob(pd), getattr(tnls, name)(), maxiters=30)
            udot = forward_ad.unpack_dual(sol.u).tangent
        assert torch.isnan(udot).all()

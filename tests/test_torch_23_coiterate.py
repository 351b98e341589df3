"""The two engines run the same algorithm on every case whose counts
``test_torch_23_qn.py`` exempts: on each of those (row, problem) cases the
port's first ten iterates agree with the JAX package's (its iterator
interface, ``NonlinearSolveCache.step``) to rel-inf 1e-6 (up to the step
before its knife-edge where that comes sooner), so a count that differs
later is a matter of rounding, not of the algorithm.  A
polyalgorithm's case runs its first rung (Broyden for the default ladder,
TrustRegion for RobustMultiNewton)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.core.cache import NonlinearSolveCache
from nonlinearsolve_tpu.models.problems23 import PROBLEMS_23 as JPROBLEMS
from nonlinearsolve_tpu_torch.core.autodiff import \
    construct_dense_jacobian_fn
from nonlinearsolve_tpu_torch.core.descent import DescentCtx
from nonlinearsolve_tpu_torch.core.jacobian import construct_jacobian
from nonlinearsolve_tpu_torch.core.termination import \
    default_termination_mode
from nonlinearsolve_tpu_torch.models import problems23 as tp23
from nonlinearsolve_tpu_torch.solvers import first_order as tfo
from nonlinearsolve_tpu_torch.solvers import quasi_newton as tqn
from nonlinearsolve_tpu_torch.solvers import spectral as tsp
from test_23_problems import _large_n_problems
from test_torch_23_qn import (BROKEN_KNIFE_EDGES, EXEMPT, LARGE_N,
                              LARGE_N_EXEMPT, ROWS, LARGE_N_ROWS, ids)

torch.set_num_threads(1)

STEPS = 10
RTOL = 1e-6
# cases that reach their knife-edge within ten steps: compared up to it
STEPS_BEFORE_EDGE = {
    # at step 8 a diagonal entry of J cancels to the rounding level (1.8e-16
    # in the port) in both packages, and step 9 jumps by its inverse
    ("Klement-TrueJacDiagonal", 18): 8,
}
FIRST_RUNG = {"DefaultPolyalgorithm": lambda m: m.Broyden(),
              "RobustMultiNewton": lambda m: m.TrustRegion()}


def port_iterates(alg, f, start, k):
    """The port's first ``k`` iterates (fewer when it stops sooner)."""
    u0 = torch.tensor(start)
    ctx = DescentCtx(f_flat=lambda u: f(u, None), n_in=u0.numel(),
                     n_out=u0.numel())
    tc = default_termination_mode(False)
    tol = np.float64(3e-13)
    if isinstance(alg, tnls.QuasiNewtonAlgorithm):
        alg = tqn.resolve_low_rank(alg, u0.numel())
        jac = construct_dense_jacobian_fn(ctx.f_flat, alg.jacobian,
                                          ctx.n_in, ctx.n_out)
        carry = tqn.init_quasi_newton(alg, ctx, tc, jac, u0, tol)
        step = lambda c: tqn.step_quasi_newton(alg, ctx, tc, jac, c, tol,
                                               tol)
    elif isinstance(alg, tnls.GeneralizedDFSane):
        carry = tsp.init_dfsane(alg, ctx, tc, u0, tol)
        step = lambda c: tsp.step_dfsane(alg, ctx, tc, c, tol, tol)
    else:
        jac = construct_jacobian(alg.jacobian, alg.get_linsolve(), ctx,
                                 None, alg.concrete_jac)[0]
        carry = tfo.init_first_order(alg, ctx, tc, u0, tol)
        step = lambda c: tfo.step_first_order(alg, ctx, tc, jac, c, tol,
                                              tol)
    out = []
    while len(out) < k and not carry.force_stop:
        carry = step(carry)
        out.append(carry.u.numpy().copy())
    return out


def jax_iterates(alg, f, start, k):
    cache = NonlinearSolveCache(
        jnls.NonlinearProblem(f, jnp.asarray(start)), alg, maxiters=10000)
    out = []
    for _ in range(k):
        cache.step(1)
        out.append(np.asarray(cache.u))
    return out


def _problem(row, index):
    if row in LARGE_N_ROWS:
        (jf, x0), = [(f, x0) for i, f, x0 in _large_n_problems(LARGE_N)
                     if i == index]
        return LARGE_N_ROWS[row][0], jf, getattr(tp23, jf.__name__), \
            np.asarray(x0, np.float64)
    jp = JPROBLEMS[index - 1]
    make = FIRST_RUNG.get(row, ROWS[row][0])
    return make, jp.f, tp23.PROBLEMS_23[index - 1].f, jp.start


CASES_HERE = sorted(set(EXEMPT) | set(BROKEN_KNIFE_EDGES)
                    | set(LARGE_N_EXEMPT))


@pytest.mark.parametrize("row,index", CASES_HERE, ids=ids(CASES_HERE))
def test_exempt_cases_co_iterate(row, index):
    make, jf, tf, start = _problem(row, index)
    mine = port_iterates(make(tnls), tf, start,
                         STEPS_BEFORE_EDGE.get((row, index), STEPS))
    ref = jax_iterates(make(jnls), jf, start, len(mine))
    assert mine
    for k, (a, b) in enumerate(zip(mine, ref)):
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1.0)
        assert rel <= RTOL, (k + 1, rel)

"""Dense Jacobians of the port (``core/autodiff.py``, ``core/jacobian.py``)
against the JAX package's, f64 on the CPU, on the same numpy states:
forward (``jacfwd``), chunked forward, reverse (``jacrev``) and forward
differences, for the Brusselator at N=8 (a shaped (8, 8, 2) state: the
Jacobian comes back (128, 128)) and three of the 23 problems (Wood;
Watson, whose residual is itself a gradient; Broyden banded).

Tolerances, rel-inf of max|J|: 1e-13 for the AD Jacobians (the same
products, summed in other orders at most); 1e-7 for finite differences,
whose division by the step h = √eps·max(|u|, 1) ≈ 1.5e-8 multiplies the two
packages' rounding differences in f (≈ 1e-16·|f|) by 1/h.

Also: the dense Brusselator root of the JAX package carried across by
``interop.problem_from_numpy`` and polished by the port's dense
NewtonRaphson in one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.core import autodiff as jad
from nonlinearsolve_tpu.core import jacobian as jjac
from nonlinearsolve_tpu.core.descent import DescentCtx as JCtx
from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.models.problems23 import PROBLEMS_23 as JP
from nonlinearsolve_tpu_torch import interop
from nonlinearsolve_tpu_torch.core import autodiff as tad
from nonlinearsolve_tpu_torch.core import jacobian as tjac
from nonlinearsolve_tpu_torch.core.descent import DescentCtx as TCtx
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.models.problems23 import PROBLEMS_23 as TP

torch.set_num_threads(2)

AD_RTOL = 1e-13
FD_RTOL = 1e-7
MODES = [("forward", None), ("forward", 5), ("reverse", None),
         ("finite", None)]


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _jacobians(jf, tf, u, mode, chunk, n_out):
    n_in = u.size
    jpol = jnls.JacobianPolicy(mode=mode, chunk_size=chunk)
    tpol = tnls.JacobianPolicy(mode=mode, chunk_size=chunk)
    jfn, jkind = jjac.construct_jacobian(
        jpol, None, JCtx(f_flat=jf, n_in=n_in, n_out=n_out,
                         is_least_squares=False), None)
    tfn, tkind = tjac.construct_jacobian(
        tpol, None, TCtx(f_flat=tf, n_in=n_in, n_out=n_out), None)
    assert jkind == tkind == "dense"
    J = np.asarray(jfn(jnp.asarray(u)))
    with torch.no_grad():
        T = tfn(torch.tensor(u)).numpy()
    assert T.shape == J.shape == (n_out, n_in)
    return J, T


@pytest.mark.parametrize("mode,chunk", MODES)
def test_brusselator_jacobian(mode, chunk):
    N = 8
    jprob = jbru.make_problem(N)
    u0 = np.asarray(jprob.u0)
    p = np.asarray(jprob.p)
    tp_ = torch.tensor(p)
    if mode == "forward" and chunk is None or mode == "reverse":
        # the shaped state: out_shape + in_shape made 2-D in C order
        u = u0

        def jf(v):
            return jbru.brusselator_2d(v, jnp.asarray(p))

        def tf(v):
            return tbru.brusselator_2d(v, tp_)
    else:
        # chunked forward and finite differences take a flat state
        u = u0.reshape(-1)

        def jf(v):
            return jbru.brusselator_2d(v.reshape(N, N, 2),
                                       jnp.asarray(p)).reshape(-1)

        def tf(v):
            return tbru.brusselator_2d(v.reshape(N, N, 2), tp_).reshape(-1)
    J, T = _jacobians(jf, tf, u, mode, chunk, 2 * N * N)
    assert _rel(T, J) <= (FD_RTOL if mode == "finite" else AD_RTOL)


@pytest.mark.parametrize("mode,chunk", MODES)
@pytest.mark.parametrize("index", [4, 6, 14])
def test_problem_jacobians(index, mode, chunk):
    jp, tp = JP[index - 1], TP[index - 1]
    u = jp.start + 0.25
    J, T = _jacobians(lambda v: jp.f(v, None), lambda v: tp.f(v, None), u,
                      mode, chunk, u.size)
    assert _rel(T, J) <= (FD_RTOL if mode == "finite" else AD_RTOL)


def test_analytic_jacobian_wins():
    calls = []

    def jac(u, p):
        calls.append(1)
        return torch.diag(2.0 * u)

    f = tnls.NonlinearFunction(f=lambda u, p: u * u - p, jac=jac)
    prob = tnls.NonlinearProblem(f, torch.tensor([1.0, 3.0],
                                                 dtype=torch.float64), 2.0)
    sol = tnls.solve(prob, tnls.NewtonRaphson(), abstol=1e-12)
    assert sol.retcode == tnls.ReturnCode.Success and calls
    np.testing.assert_allclose(sol.u.numpy(), np.sqrt(2.0), rtol=1e-12)


def test_pickchunksize_and_resolve_match_jax():
    for n in (1, 5, 12, 13, 25, 100, 2048):
        assert tad.pickchunksize(n) == jad.pickchunksize(n)
    for n_in, n_out in ((10, 10), (100, 10), (10, 100), (40, 10)):
        assert tad.JacobianPolicy().resolve(n_in, n_out) == \
            jad.JacobianPolicy().resolve(n_in, n_out)


def test_jax_dense_root_polished_by_the_port():
    """The JAX package's dense-NR Brusselator root (N=8, stopped at abstol
    1e-6), carried across through numpy, is polished by the port's dense
    NewtonRaphson in one step to abstol 1e-10 (Newton's quadratic step; the
    f64 floor of this residual is about 2e-12), and lands within 1e-10 of
    the JAX package's own root at abstol 1e-10."""
    N = 8
    jprob = jbru.make_problem(N)
    rough = jnls.solve(jprob, jnls.NewtonRaphson(), abstol=1e-6)
    fine = jnls.solve(jprob, jnls.NewtonRaphson(), abstol=1e-10)
    assert int(rough.retcode) == int(fine.retcode) == 1
    tprob = interop.problem_from_numpy(np.asarray(rough.u),
                                       np.asarray(jprob.p), device="cpu")
    assert float(tprob.f(tprob.u0, tprob.p).abs().max()) > 1e-10
    tsol = tnls.solve(tprob, tnls.NewtonRaphson(), abstol=1e-10,
                      maxiters=1)
    assert tsol.retcode == tnls.ReturnCode.Success
    assert tsol.stats.nsteps == 1
    assert float(tsol.resid.abs().max()) <= 1e-10
    assert np.abs(tsol.u.numpy() - np.asarray(fine.u)).max() <= 1e-10
    out = interop.solution_to_numpy(tsol)
    assert out["u"].shape == (N, N, 2) and out["retcode"] == 1
    jax.clear_caches()

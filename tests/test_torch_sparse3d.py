"""The two new routes of the assembled sparse path as whole solves, the port
against the JAX package on the CPU (f64): Newton, GMRES(8) with the 3D FFT
Poisson preconditioner (shift −0.9) and Eisenstat–Walker η = 0.1 on a
colored sparse-AD Jacobian of the flat 3D reaction–diffusion residual.

- The band route: 16³ with the DIA and x caps lowered on both sides, so
  that both packages pick the "stream" tier, as they do at 256³ with the
  caps as they are.  The port runs K7's plain version in every product.
- The scatter route: 20³ with its unknowns numbered by a seeded
  permutation, where both packages pick the "scatter" tier; the port runs
  K8's plain versions.  Permuted back, its root is the natural-order one
  (the DIA tier).

Both: the same retcode and NLStats, roots within 1e-10.  The periodic
7-point pattern the solves are given (numpy) equals the JAX package's
jaxpr tracer's.
"""

import jax.numpy as jnp
import numpy as np
import torch

import nonlinearsolve_tpu as jnls
from nonlinearsolve_tpu.models import reaction_diffusion as jrd
from nonlinearsolve_tpu.ops import pallas_spmv as jps
from nonlinearsolve_tpu.ops import sparse as jsp
from nonlinearsolve_tpu.ops.preconditioners import \
    fft_poisson_preconditioner as jfft
from nonlinearsolve_tpu.ops.sparsity_trace import detect_sparsity_exact
from nonlinearsolve_tpu.solvers.first_order import \
    EisenstatWalkerForcing as JEW
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu_torch import interop
from nonlinearsolve_tpu_torch.core import solve as tsolve
from nonlinearsolve_tpu_torch.models import reaction_diffusion as trd
from nonlinearsolve_tpu_torch.ops import spmv as tps
from nonlinearsolve_tpu_torch.ops.preconditioners import \
    fft_poisson_preconditioner as tfft
from test_torch_spmv_stream import caps, periodic7  # noqa: F401

torch.set_num_threads(2)

STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")
D = 0.01
ABSTOL = 1e-8


def _coo(N, perm=None):
    indptr, cols = periodic7(N)
    rows = np.repeat(np.arange(N ** 3), np.diff(indptr))
    if perm is None:
        return rows, cols
    pinv = np.argsort(perm)
    return pinv[rows], pinv[cols]


def _problems(N, perm=None):
    """The flat 3D problem in both packages (with ``perm``: w = u[perm],
    G(w) = F(w[pinv])[perm]), given its periodic 7-point pattern."""
    u0 = np.full(N ** 3, 0.1)
    pinv = None if perm is None else np.argsort(perm)
    if perm is not None:
        u0 = u0[perm]
    coo = _coo(N, perm)

    def jf(u, p):
        x = u if pinv is None else u[jnp.asarray(pinv)]
        r = jrd.reaction_diffusion_3d(x.reshape(N, N, N), p).reshape(-1)
        return r if perm is None else r[jnp.asarray(perm)]

    def tf(u, p):
        x = u if pinv is None else u[torch.as_tensor(pinv)]
        r = trd.reaction_diffusion_3d(x.reshape(N, N, N), p).reshape(-1)
        return r if perm is None else r[torch.as_tensor(perm)]

    jprob = jnls.NonlinearProblem(
        jnls.NonlinearFunction(f=jf, sparsity=coo), jnp.asarray(u0),
        (jnp.asarray(D), jrd.forcing(N)))
    tprob = tnls.NonlinearProblem(
        tnls.NonlinearFunction(f=tf, sparsity=coo), torch.tensor(u0),
        (torch.tensor(D, dtype=torch.float64),
         trd.forcing(N, device="cpu")))
    return jprob, tprob


def _algs(N, perm=None):
    kw = dict(method="gmres", restart=8, krylov_maxiter=200)
    jM = jfft((N, N, N), D, 1.0 / N, shift=-0.9)
    tM = tfft((N, N, N), D, 1.0 / N, shift=-0.9)
    if perm is not None:
        pinv = np.argsort(perm)
        jperm, jpinv = jnp.asarray(perm), jnp.asarray(pinv)
        tperm, tpinv = torch.as_tensor(perm), torch.as_tensor(pinv)
        jM = (lambda v, M=jM: M(v[jpinv])[jperm])
        tM = (lambda v, M=tM: M(v[tpinv])[tperm])
    jalg = jnls.NewtonRaphson(
        autodiff=jnls.JacobianPolicy(mode="sparse"),
        linsolve=jnls.LinearSolver(precond_fn=jM, **kw),
        forcing=JEW(eta_0=0.1, eta_max=0.1))
    talg = tnls.NewtonRaphson(
        autodiff=tnls.JacobianPolicy(mode="sparse"),
        linsolve=tnls.LinearSolver(precond_fn=tM, **kw),
        forcing=tnls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    return jalg, talg


def _solve_both(N, perm=None):
    jprob, tprob = _problems(N, perm)
    jalg, talg = _algs(N, perm)
    jsol = jnls.solve(jprob, jalg, abstol=ABSTOL, maxiters=30)
    tsol = tnls.solve(tprob, talg, abstol=ABSTOL, maxiters=30)
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert {k: int(getattr(tsol.stats, k)) for k in STATS} == \
        {k: int(getattr(jsol.stats, k)) for k in STATS}
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-10)
    assert float(tsol.resid.abs().max()) <= ABSTOL
    plan, = tsolve._SPARSE_PLANS[tprob.f].values()
    return tsol, plan


def _tiers(N, perm=None):
    rows, cols = _coo(N, perm)
    pat = jsp.CSR.from_pattern(rows, cols, (N ** 3, N ** 3))
    jt = jps.select_spmv_plan(pat.indptr, pat.indices, *pat.shape)[0]
    tt = tps.select_spmv_plan(pat.indptr, pat.indices, *pat.shape)[0]
    return jt, tt


def test_band_route_solve_matches_jax(caps):
    N = 16
    caps(DIA_MAX_TABLE=50_000, MAX_X_ELEMS_VMEM=2048)
    assert _tiers(N) == ("stream", "stream")
    tsol, plan = _solve_both(N)
    tier, bplan, perm, _, _ = plan.pattern.tier
    assert tier == "stream" and perm is None and plan.dia_plan is None
    assert (bplan.w, len(bplan.bands)) == (9, 3)
    assert tsol.counters["jvp"] >= tsol.counters["krylov_iters"] > 0


def test_scatter_route_solve_matches_jax_and_the_natural_root(caps):
    N = 20
    perm = np.random.default_rng(42).permutation(N ** 3)
    assert _tiers(N, perm) == ("scatter", "scatter")
    tsol, plan = _solve_both(N, perm)
    tier, splan = plan.pattern.tier[:2]
    assert tier == "scatter" and len(splan.parts) == 1
    # the natural order takes the DIA tier; permuted back, the same root
    _, tprob0 = _problems(N)
    root = tnls.solve(tprob0, _algs(N)[1], abstol=ABSTOL, maxiters=30)
    plan0, = tsolve._SPARSE_PLANS[tprob0.f].values()
    assert plan0.dia_plan is not None
    np.testing.assert_allclose(tsol.u.numpy()[np.argsort(perm)],
                               root.u.numpy(), rtol=0, atol=1e-10)


def test_periodic7_pattern_equals_jax_tracer():
    N = 16
    n = N ** 3
    p = (jnp.asarray(D), jrd.forcing(N))
    traced = detect_sparsity_exact(
        lambda u: jrd.reaction_diffusion_3d(u.reshape(N, N, N),
                                            p).reshape(-1), n)
    indptr, cols = periodic7(N)
    np.testing.assert_array_equal(np.asarray(traced.indptr), indptr)
    np.testing.assert_array_equal(np.asarray(traced.indices), cols)


def test_csr_from_numpy_carries_a_jax_csr():
    rows, cols = _coo(8, np.random.default_rng(1).permutation(512))
    data = np.random.default_rng(2).standard_normal(len(rows))
    J = jsp.CSR.from_pattern(rows, cols, (512, 512), data=jnp.asarray(data))
    T = interop.csr_from_numpy(J.indptr, J.indices, np.asarray(J.data),
                               J.shape, device="cpu")
    assert T.data.dtype == torch.float64 and T.shape == (512, 512)
    np.testing.assert_array_equal(T.indices, J.indices)
    x = np.random.default_rng(3).standard_normal(512)
    np.testing.assert_allclose(T.matvec(torch.tensor(x)).numpy(),
                               np.asarray(J.matvec(jnp.asarray(x))),
                               rtol=0, atol=1e-12)

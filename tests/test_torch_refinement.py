"""Mixed-precision refinement (``solvers/refinement.py``: ``refine_root``,
``auto_refine``) against the JAX package on the CPU (ROADMAP A.27).

Small cases (n ≤ 16 unknowns, least squares at 8 × 16) run both packages
live from the same f32 root: the refined roots agree within 1e-12 and
each meets the bound of ``tests/test_refinement.py``.  The costly JAX runs
(``TestRefineRoot`` at N = 16, about 11 s, and the Bratu 32² anchor,
about 14 s) come from ``tools/refinement_reference.py``'s recorded output
(``JAX_REFINED`` below): the port's live run gives the same f32-solve
NLStats, the JAX test's bounds, and the refined root's checksums within
1e-12 relative of the JAX package's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize as so
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.ops import doublef32 as J
from nonlinearsolve_tpu.ops.doublef32_eval import df_eval as jdf_eval
from nonlinearsolve_tpu_torch.models import bratu as tbratu
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.models import reaction_diffusion as trd
from nonlinearsolve_tpu_torch.ops import doublef32 as T
from nonlinearsolve_tpu_torch.ops.doublef32_eval import df_eval as tdf_eval
from nonlinearsolve_tpu_torch.ops.preconditioners import \
    fft_poisson_preconditioner as tfft

torch.set_num_threads(1)

# tools/refinement_reference.py on a CPU (JAX 0.9.0, f64): the f32 solve's
# retcode and NLStats, and the refined root's checksums (sum, max, dot
# with a numpy-seed-7 normal vector)
JAX_REFINED = {
    "flagship": {"retcode": 1, "stats": [4, 2, 2, 2, 2],
                 "fast_rel": 6.925199467840036e-05,
                 "refined_rel": 2.1436306375165264e-12,
                 "defect": 2.376765451117535e-10,
                 "checksums": [1056.7122315299766, 2.9910750012580642,
                               -165.68321198108183]},
    "bratu": {"retcode": 1, "stats": [4, 2, 2, 2, 2],
              "fast_rel": 3.999633997970883e-05,
              "refined_rel": 3.14139314341864e-13,
              "defect": 1.1404210908949608e-11,
              "checksums": [165.66509351553185, 0.3288548988456599,
                            -12.239280463994685]},
}


def _stats(sol):
    s = sol.stats
    return [int(s.nf), int(s.njacs), int(s.nfactors), int(s.nsolve),
            int(s.nsteps)]


def _checksums(u):
    u = np.asarray(u, np.float64).reshape(-1)
    w = np.random.default_rng(7).standard_normal(u.size)
    return [float(u.sum()), float(u.max()), float(u @ w)]


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def _cubic_pair(n, seed):
    b = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    jb, tb = jnp.asarray(b), torch.tensor(b)
    jprob = jnls.NonlinearProblem(lambda u, p: u ** 3 + p * u - jb,
                                  jnp.zeros(n, jnp.float32),
                                  jnp.asarray(1.0, jnp.float32))
    tprob = tnls.NonlinearProblem(lambda u, p: u ** 3 + p * u - tb,
                                  torch.zeros(n, dtype=torch.float32),
                                  torch.tensor(1.0, dtype=torch.float32))
    return b, jprob, tprob


def test_auto_refine_one_call_matches_jax():
    b, jprob, tprob = _cubic_pair(16, 0)
    jsol = jnls.solve(jprob, jnls.NewtonRaphson(), abstol=1e-4)
    tsol = tnls.solve(tprob, tnls.NewtonRaphson(), abstol=1e-4)
    np.testing.assert_array_equal(tsol.u.numpy(), np.asarray(jsol.u))
    jres = jnls.auto_refine(jprob, jsol.u, rounds=3)
    tres = tnls.auto_refine(tprob, tsol.u, rounds=3)
    u_ref = T.df_value_f64(tres.u)
    assert np.abs(u_ref - J.df_value_f64(jres.u)).max() < 1e-12
    b64 = b.astype(np.float64)
    u32 = tsol.u.double().numpy()
    before = np.abs(u32 ** 3 + u32 - b64).max()
    after = np.abs(u_ref ** 3 + u_ref - b64).max()
    assert after < 1e-12 and after < before / 1e4
    assert tres.rounds == 3 and float(tres.defect_norm) < 1e-10


def test_refine_root_with_generic_defect_matches_jax():
    n = 16
    b64 = np.random.default_rng(3).standard_normal(n)
    b32 = b64.astype(np.float32)
    tsol = tnls.solve(tnls.NonlinearProblem(
        lambda u, p: u ** 3 + u - torch.tensor(b32),
        torch.zeros(n, dtype=torch.float32)), tnls.NewtonRaphson(),
        abstol=1e-4)
    tb_df = T.df_from_f64(b64, device="cpu")
    hi = jnp.asarray(b64, jnp.float32)
    jb_df = J.DF(hi, jnp.asarray(b64 - np.asarray(hi, np.float64),
                                 jnp.float32))

    def tres_df(uh, ul):
        out = tdf_eval(lambda u, bb: u ** 3 + u - bb, T.DF(uh, ul), tb_df)
        return out.hi, out.lo

    def jres_df(uh, ul):
        out = jdf_eval(lambda u, bb: u ** 3 + u - bb, J.DF(uh, ul), jb_df)
        return out.hi, out.lo

    tres = tnls.refine_root(tsol.u, tres_df,
                            lambda uh: (lambda v: (3.0 * uh ** 2 + 1.0) * v),
                            rounds=3)
    jres = jnls.refine_root(jnp.asarray(tsol.u.numpy()), jres_df,
                            lambda uh: (lambda v: (3.0 * uh ** 2 + 1.0) * v),
                            rounds=3)
    u_ref = T.df_value_f64(tres.u)
    assert np.abs(u_ref - J.df_value_f64(jres.u)).max() < 1e-12
    assert np.abs(u_ref ** 3 + u_ref - b64).max() < 1e-11


def test_uses_analytic_jvp_and_refines_exp():
    calls = {"n": 0}
    b32 = np.random.default_rng(1).standard_normal(16).astype(np.float32)
    tb = torch.tensor(b32)

    def jvp(v, u, p):
        calls["n"] += 1
        return (3.0 * u ** 2 + 1.0) * v

    prob = tnls.NonlinearProblem(
        tnls.NonlinearFunction(f=lambda u, p: u ** 3 + u - tb, jvp=jvp),
        torch.zeros(16, dtype=torch.float32))
    sol = tnls.solve(prob, tnls.NewtonRaphson(), abstol=1e-4)
    calls["n"] = 0
    res = tnls.auto_refine(prob, sol.u, rounds=2)
    assert calls["n"] > 0
    assert float(res.defect_norm) < 1e-10
    # exp is a genuine double-word rule: e^u − 2 refines to log 2
    jprob = jnls.NonlinearProblem(lambda u, p: jnp.exp(u) - 2.0,
                                  jnp.zeros(4, jnp.float32))
    tprob = tnls.NonlinearProblem(lambda u, p: torch.exp(u) - 2.0,
                                  torch.zeros(4, dtype=torch.float32))
    tsol = tnls.solve(tprob, tnls.NewtonRaphson(), abstol=1e-4)
    tres = tnls.auto_refine(tprob, tsol.u, rounds=3)
    jres = jnls.auto_refine(jprob, jnp.asarray(tsol.u.numpy()), rounds=3)
    u_ref = T.df_value_f64(tres.u)
    assert np.max(np.abs(u_ref - np.log(2.0))) < 1e-12
    assert np.abs(u_ref - J.df_value_f64(jres.u)).max() < 1e-12


def test_transcendental_guidance_and_first_order_overlay():
    prob = tnls.NonlinearProblem(lambda u, p: torch.tanh(u) - 0.5,
                                 torch.zeros(4, dtype=torch.float32))
    sol = tnls.solve(prob, tnls.NewtonRaphson(), abstol=1e-4)
    with pytest.raises(NotImplementedError, match="register a rule"):
        tnls.auto_refine(prob, sol.u, rounds=1)
    n = 16
    b32 = (np.random.default_rng(0).uniform(1.0, 3.0, n) * 1e5).astype(
        np.float32)
    tb = torch.tensor(b32)
    prob = tnls.NonlinearProblem(lambda u, p: torch.exp(u) + 1e5 * u - tb,
                                 torch.zeros(n, dtype=torch.float32))
    sol = tnls.solve(prob, tnls.NewtonRaphson(), abstol=1e-1)
    assert sol.retcode == tnls.ReturnCode.Success
    res = tnls.auto_refine(prob, sol.u, rounds=3,
                           first_order_transcendentals=True)
    u_ref = T.df_value_f64(res.u)
    b64 = b32.astype(np.float64)
    u32 = sol.u.double().numpy()
    before = np.abs(np.exp(u32) + 1e5 * u32 - b64).max()
    after = np.abs(np.exp(u_ref) + 1e5 * u_ref - b64).max()
    assert after < 1e-5 and after < before / 100


def test_least_squares_refinement_matches_jax():
    """A zero-residual least-squares problem: the Gauss–Newton normal
    equations through vjp∘jvp, in both packages from the same root."""
    rng = np.random.default_rng(0)
    n, m = 8, 16
    A64 = rng.standard_normal((m, n)) * 10
    y = A64 @ rng.standard_normal(n)
    A32 = A64.astype(np.float32)
    b32 = (y + 0.1 * y ** 3).astype(np.float32)
    jA, jb, tA, tb = (jnp.asarray(A32), jnp.asarray(b32), torch.tensor(A32),
                      torch.tensor(b32))

    def jf(u, p):
        w = jA @ u
        return w + 0.1 * w ** 3 - jb

    def tf(u, p):
        w = tA @ u
        return w + 0.1 * w ** 3 - tb

    tprob = tnls.NonlinearLeastSquaresProblem(
        tf, torch.zeros(n, dtype=torch.float32))
    tsol = tnls.solve(tprob, tnls.GaussNewton(), abstol=1e-3, maxiters=100)
    assert tsol.retcode == tnls.ReturnCode.Success
    tres = tnls.auto_refine(tprob, tsol.u, rounds=4)
    jres = jnls.auto_refine(jnls.NonlinearLeastSquaresProblem(
        jf, jnp.zeros(n, jnp.float32)), jnp.asarray(tsol.u.numpy()),
        rounds=4)
    u_ref = T.df_value_f64(tres.u)
    assert np.abs(u_ref - J.df_value_f64(jres.u)).max() < 1e-12
    A_ex, b_ex = A32.astype(np.float64), b32.astype(np.float64)
    r = so.least_squares(lambda u: A_ex @ u + 0.1 * (A_ex @ u) ** 3 - b_ex,
                         tsol.u.double().numpy(), xtol=1e-15, ftol=1e-15)
    before = np.abs(tsol.u.double().numpy() - r.x).max()
    after = np.abs(u_ref - r.x).max()
    assert after < 1e-7 and after < before / 10


def test_flagship_refinement_against_the_recorded_jax_run():
    """``TestRefineRoot``'s N = 16 case: f32 Newton–GMRES root, refined
    with ``brusselator_2d_df32``, within 1e-8 rel-inf of the f64 root."""
    N = 16
    ref = JAX_REFINED["flagship"]
    pm = tfft((N, N), alpha=10.0, h=1.0 / (N - 1), shift=3.0,
              n_components=2)
    alg = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=16,
                                   krylov_maxiter=100, precond_fn=pm),
        forcing=tnls.EisenstatWalkerForcing(eta_0=1e-2, eta_max=1e-2))
    sol32 = tnls.solve(tbru.make_problem(N, torch.float32, device="cpu"),
                       alg, abstol=0.05, maxiters=30)
    assert [int(sol32.retcode)] + _stats(sol32) == \
        [ref["retcode"]] + ref["stats"]
    alg64 = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=16,
                                   krylov_maxiter=200, precond_fn=pm),
        forcing=tnls.EisenstatWalkerForcing(eta_0=1e-4, eta_max=1e-4))
    sol64 = tnls.solve(tbru.make_problem(N, torch.float64, device="cpu"),
                       alg64, abstol=1e-8, maxiters=50)
    assert sol64.retcode == tnls.ReturnCode.Success
    p64 = tbru.default_p(N, torch.float64, device="cpu")
    p32 = tbru.default_p(N, torch.float32, device="cpu")

    def jvp_at(uh):
        return lambda v: torch.func.jvp(
            lambda U: tbru.brusselator_2d(U, p32), (uh,), (v,))[1]

    res = tnls.refine_root(
        sol32.u, lambda uh, ul: tbru.brusselator_2d_df32(uh, ul, p64),
        jvp_at, rounds=3, inner_rtol=1e-2, restart=16, precond_fn=pm)
    u_ref = T.df_value_f64(res.u)
    u64 = sol64.u.numpy()
    err_before = _rel(sol32.u.double().numpy(), u64)
    err_after = _rel(u_ref, u64)
    assert err_after < 1e-8 and err_after < err_before / 10.0
    assert float(res.defect_norm) < 1e-6
    np.testing.assert_allclose(_checksums(u_ref), ref["checksums"],
                               rtol=1e-12)


def test_bratu_anchor_against_the_recorded_jax_run():
    """``auto_refine`` on Bratu 32² (an e^u residual through df_exp):
    within 1e-9 rel-inf of the f64 root and 10× better than the f32
    root."""
    N = 32
    ref = JAX_REFINED["bratu"]
    prob32 = tbratu.make_problem(N, dtype=torch.float32, device="cpu")
    sol = tnls.solve(prob32, tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=32)),
        abstol=1e-3, maxiters=50)
    assert [int(sol.retcode)] + _stats(sol) == \
        [ref["retcode"]] + ref["stats"]
    res = tnls.auto_refine(prob32, sol.u, rounds=4)
    u_ref = T.df_value_f64(res.u)
    sol64 = tnls.solve(tbratu.make_problem(N, dtype=torch.float64,
                                           device="cpu"),
                       tnls.NewtonRaphson(), abstol=1e-12, maxiters=100)
    u64 = sol64.u.numpy()
    rel_inf = _rel(u_ref, u64)
    fast_rel = _rel(sol.u.double().numpy(), u64)
    assert rel_inf < 1e-9 and rel_inf < fast_rel / 10.0
    np.testing.assert_allclose(_checksums(u_ref), ref["checksums"],
                               rtol=1e-12)


def test_auto_refine_3d_reaction_diffusion():
    """The 3D reaction–diffusion residual is polynomial: auto_refine
    certifies it with no extra code (the JAX test's bounds)."""
    N = 8
    prob = trd.make_problem(N, dtype=torch.float32, device="cpu")
    sol = tnls.solve(prob, tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=16)),
        abstol=1e-3, maxiters=50)
    assert sol.retcode == tnls.ReturnCode.Success
    res = tnls.auto_refine(prob, sol.u, rounds=3)
    d_before = float(sol.resid.abs().max())
    d_after = float(res.defect_norm)
    assert d_after < 1e-8 and d_after < d_before


def test_stage_precond_contract():
    from nonlinearsolve_tpu_torch.solvers.refinement import _stage_precond
    u = torch.ones(3)
    plain = (lambda v: 2.0 * v)
    assert _stage_precond(None, u, u) is None
    assert _stage_precond(plain, u, u) is plain
    factory = (lambda uu: (lambda v: v + uu))
    assert torch.equal(_stage_precond(factory, u, u)(u), 2.0 * u)

    def wants(uu, fu):
        return lambda v: v * fu
    wants.wants_residual = True
    assert torch.equal(_stage_precond(wants, u, 3.0 * u)(u), 3.0 * u)

    def bad(uu, fu):
        return 1.0
    bad.wants_residual = True
    with pytest.raises(TypeError, match="wants_residual"):
        _stage_precond(bad, u, u)

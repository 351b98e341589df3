"""``SteadyStateProblem`` with ``SSRootfind`` and ``DynamicSS`` against the
JAX package: the ten cases of ``tests/test_steady_state.py``, f64 on the
CPU.

Each solve runs in both packages on the same inputs and is held to the
JAX package's retcode and ``NLStats``, and a steady state within 1e-10
(``ATOL``; a flow that diverges to ``Unstable`` within rel 1e-10 of the
JAX package's last state), besides the JAX test's own assertions.
``test_dynamic_ss_vmap_and_jit`` maps a jitted solve over three values of
p: the port has no ``vmap`` over its host loop (ROADMAP C), so the three
solves run one by one, each held to the JAX package's lone solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls

torch.set_num_threads(1)

ATOL = 1e-10
STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def logistic(u, p):
    # du/dt = u(p − u): stable equilibrium at p, unstable at 0
    return u * (p - u)


def both(f, u0, p, alg, *, ft=None, problem="SteadyStateProblem",
         rtol=0.0, **kw):
    """The same steady-state solve in both packages (``alg(module)``);
    returns the port's solution after holding it to the JAX package's."""
    jsol = jnls.solve(getattr(jnls, problem)(f, jnp.asarray(u0), p),
                      alg(jnls), **kw)
    tp = torch.as_tensor(np.asarray(p)) if p is not None else None
    tsol = tnls.solve(getattr(tnls, problem)(
        ft or f, torch.as_tensor(np.asarray(u0, dtype=np.float64)), tp),
        alg(tnls), **kw)
    assert int(tsol.retcode) == int(jsol.retcode)
    assert tuple(getattr(tsol.stats, k) for k in STATS) == tuple(
        int(getattr(jsol.stats, k)) for k in STATS)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u),
                               rtol=rtol, atol=0.0 if rtol else ATOL)
    return tsol


@pytest.mark.parametrize("method", ["tsit5", "rosenbrock23"])
def test_dynamic_ss_finds_stable_equilibrium(method):
    sol = both(logistic, [0.1, 0.5], 1.0,
               lambda m: m.DynamicSS(method=method))
    assert sol.retcode == tnls.ReturnCode.Success
    assert float((sol.u - 1.0).abs().max()) < 1e-5
    assert float(sol.resid.abs().max()) <= 1e-6 * float(sol.u.abs().max())


def test_dynamic_ss_avoids_unstable_equilibrium_rootfind_can_hit():
    rf = both(logistic, [0.004], 1.0,
              lambda m: m.SSRootfind(m.NewtonRaphson()))
    assert abs(float(rf.u[0])) < 1e-8
    dyn = both(logistic, [0.004], 1.0, lambda m: m.DynamicSS())
    assert dyn.retcode == tnls.ReturnCode.Success
    assert abs(float(dyn.u[0]) - 1.0) < 1e-5


def test_ssrootfind_unwraps_to_default_polyalg():
    sol = both(logistic, [0.7, 0.7], 1.0, lambda m: m.SSRootfind())
    assert sol.retcode == tnls.ReturnCode.Success
    assert sol.counters["winner"] >= 0           # the default ladder ran


A_STIFF = np.array([[-1000.0, 0.0], [1.0, -0.5]])
B_STIFF = np.array([3.0, 1.0])


def stiff_j(u, p):
    return jnp.asarray(A_STIFF) @ u + jnp.asarray(B_STIFF)


def stiff_t(u, p):
    return torch.as_tensor(A_STIFF) @ u + torch.as_tensor(B_STIFF)


def test_dynamic_ss_rosenbrock_handles_stiffness_cheaply():
    sol = both(stiff_j, np.zeros(2), None,
               lambda m: m.DynamicSS(method="rosenbrock23"), ft=stiff_t)
    assert sol.retcode == tnls.ReturnCode.Success
    np.testing.assert_allclose(sol.u.numpy(),
                               np.linalg.solve(A_STIFF, -B_STIFF), atol=1e-5)
    assert sol.stats.nsteps < 100


def test_dynamic_ss_explicit_stability_cap_terminates():
    sol = both(logistic, [0.1], 1.0, lambda m: m.DynamicSS(method="tsit5"),
               maxiters=500)
    assert sol.retcode == tnls.ReturnCode.Success
    assert sol.stats.nsteps < 100


def focus_j(u, p):
    return jnp.array([1.0 - 2.5 * u[0] + u[0] ** 2 * u[1],
                      1.5 * u[0] - u[0] ** 2 * u[1]])


def focus_t(u, p):
    return torch.stack([1.0 - 2.5 * u[0] + u[0] ** 2 * u[1],
                        1.5 * u[0] - u[0] ** 2 * u[1]])


def test_dynamic_ss_oscillatory_focus():
    """The Brusselator ODE with a = 1, b = 1.5: a stable focus."""
    sol = both(focus_j, [1.5, 2.0], None, lambda m: m.DynamicSS(),
               ft=focus_t)
    assert sol.retcode == tnls.ReturnCode.Success
    np.testing.assert_allclose(sol.u.numpy(), [1.0, 1.5], atol=1e-4)


def test_dynamic_ss_tspan_exhaustion_is_maxtime():
    sol = both(lambda u, p: -0.01 * u, [1.0], None,
               lambda m: m.DynamicSS(tspan=10.0))
    assert sol.retcode == tnls.ReturnCode.MaxTime
    assert abs(float(sol.u[0]) - np.exp(-0.1)) < 1e-4


def test_dynamic_ss_divergent_flow_is_unstable():
    """The flow from −0.01 blows up: the step collapses (Unstable) at a
    state near −2.3e12, the same to rel 1e-10 in both packages."""
    sol = both(logistic, [-0.01], 1.0, lambda m: m.DynamicSS(tspan=50.0),
               rtol=1e-10)
    assert sol.retcode in (tnls.ReturnCode.Unstable, tnls.ReturnCode.MaxTime)


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0])
def test_dynamic_ss_vmap_and_jit(p):
    """One value of the JAX test's vmap, as a lone solve."""
    sol = both(logistic, [0.2], p, lambda m: m.DynamicSS())
    assert abs(float(sol.u[0]) - p) < 1e-4


def test_dynamic_ss_on_plain_nonlinear_problem():
    sol = both(logistic, [0.3], 1.0, lambda m: m.DynamicSS(),
               problem="NonlinearProblem")
    assert sol.retcode == tnls.ReturnCode.Success
    assert abs(float(sol.u[0]) - 1.0) < 1e-5


def test_steady_state_problem_keeps_its_function():
    """``to_nonlinear`` keeps the ``NonlinearFunction`` (its analytic
    derivatives) and the bounds; DynamicSS's tolerances default to 1e-8 /
    1e-6 only when the caller gives none."""
    f = tnls.NonlinearFunction(logistic,
                               jac=lambda u, p: torch.diag(p - 2 * u))
    u0 = torch.tensor([0.5], dtype=torch.float64)
    p = torch.tensor(1.0, dtype=torch.float64)
    prob = tnls.SteadyStateProblem(f, u0, p, lb=0.0, maxiters=7)
    nl = prob.to_nonlinear()
    assert type(nl) is tnls.NonlinearProblem and nl.f is f
    assert nl.lb == 0.0 and nl.kwargs == {"maxiters": 7}
    assert tnls.solve(prob, tnls.DynamicSS()).stats.nsteps == 7
    free = tnls.SteadyStateProblem(f, u0, p)
    loose = tnls.solve(free, tnls.DynamicSS(), abstol=1e-2, reltol=1e-2)
    tight = tnls.solve(free, tnls.DynamicSS())
    assert tight.retcode == tnls.ReturnCode.Success
    assert loose.stats.nsteps < tight.stats.nsteps

"""Derivatives through continuation solves and SCC chains against the JAX
package, f64 on the CPU: ``test_gradients_through_homotopy`` of
``tests/test_homotopy_scc.py`` and the SCC half of
``tests/test_sensitivities_bounds.py::test_gradients_through_dfsane_anderson_scc``,
then the same rule on the Bratu continuation (p scaling λ) and on a Bratu
SCC chain with a linear block and a homotopy block.

Reverse mode is ``torch.autograd.grad`` and forward mode
``torch.autograd.forward_ad``; the JAX side ``jax.grad`` and ``jax.jvp``.
The rule runs at the landing point with a dense forward Jacobian and an
LU at every size, as the JAX package's ``_homotopy_root_jvp``: each
derivative within rel 1e-10 of the JAX package's (``RTOL``), second
derivatives too.  The JAX test's default inner becomes ``NewtonRaphson()``
on both sides (the JAX test's bound against 1/(2√2) holds as well).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad as fwAD

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models.bratu import bratu_2d as jbratu
from nonlinearsolve_tpu_torch.core.autodiff import jacfwd as tjacfwd
from nonlinearsolve_tpu_torch.models.bratu import bratu_2d as tbratu

torch.set_num_threads(1)

RTOL = 1e-10
METHODS = ("HomotopySweep", "KantorovichHomotopy", "ArcLengthContinuation")


def t64(x):
    return torch.tensor(x, dtype=torch.float64)


def H_sqrt(u, q, lam):
    return u * u - (1 - lam) * 1.0 - lam * q


def _close(got, ref, rtol=RTOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    assert abs(float(got) - float(ref)) <= rtol * abs(float(ref)), (got, ref)


@pytest.mark.parametrize("name", METHODS)
def test_gradients_through_homotopy(name):
    """u*(p) = √p at λ = 1: du/dp = 1/(2√2) at p = 2 by reverse and
    forward mode, and d²u/dp² = −p^(−3/2)/4 through the rule again."""
    def jroot(p):
        return jnls.solve(jnls.HomotopyProblem(H_sqrt, jnp.array([1.0]), p),
                          getattr(jnls, name)(inner=jnls.NewtonRaphson())).u[0]

    def troot(p):
        return tnls.solve(tnls.HomotopyProblem(H_sqrt, t64([1.0]), p),
                          getattr(tnls, name)(inner=tnls.NewtonRaphson())).u[0]

    jg = jax.grad(jroot)(2.0)
    jh = jax.grad(jax.grad(jroot))(2.0)
    _, jt = jax.jvp(jroot, (2.0,), (1.0,))
    p = t64(2.0).requires_grad_(True)
    g, = torch.autograd.grad(troot(p), p, create_graph=True)
    h, = torch.autograd.grad(g, p)
    with fwAD.dual_level():
        tt = fwAD.unpack_dual(troot(fwAD.make_dual(t64(2.0), t64(1.0))))
    _close(g, jg)
    _close(tt.tangent, jt)
    _close(h, jh)
    _close(g, 1 / (2 * np.sqrt(2)), 1e-5)
    _close(h, -0.25 * 2.0 ** -1.5, 1e-5)


def test_gradients_through_scc():
    """The SCC half: u₂ = u₁ = √p through the explicit function."""
    def jroot(p):
        p1 = jnls.NonlinearProblem(lambda u, q: u * u - q, jnp.array([1.0]),
                                   p)
        p2 = jnls.NonlinearProblem(lambda u, q: u - q, jnp.array([0.0]),
                                   None)
        return jnls.solve(jnls.SCCNonlinearProblem(
            (p1, p2), explicitfuns=(None, lambda pp, sols: sols[0].u[0])),
            jnls.NewtonRaphson()).u[1]

    def troot(p):
        p1 = tnls.NonlinearProblem(lambda u, q: u * u - q, t64([1.0]), p)
        p2 = tnls.NonlinearProblem(lambda u, q: u - q, t64([0.0]), None)
        return tnls.solve(tnls.SCCNonlinearProblem(
            (p1, p2), explicitfuns=(None, lambda pp, sols: sols[0].u[0])),
            tnls.NewtonRaphson()).u[1]

    p = t64(2.0).requires_grad_(True)
    g, = torch.autograd.grad(troot(p), p)
    _close(g, jax.grad(jroot)(2.0))
    _close(g, 1 / (2 * np.sqrt(2)), 1e-6)
    # the JAX test's default algorithm, in the port
    p1 = tnls.NonlinearProblem(lambda u, q: u * u - q, t64([1.0]), p)
    p2 = tnls.NonlinearProblem(lambda u, q: u - q, t64([0.0]), None)
    u = tnls.solve(tnls.SCCNonlinearProblem(
        (p1, p2), explicitfuns=(None, lambda pp, sols: sols[0].u[0]))).u[1]
    g, = torch.autograd.grad(u, p)
    _close(g, 1 / (2 * np.sqrt(2)), 1e-6)


N = 6
W = np.random.default_rng(24).standard_normal(3 * N * N)


def Hp_j(u, p, lam):
    return jbratu(u, lam * p)


def Hp_t(u, p, lam):
    return tbratu(u, lam * p)


def test_gradient_through_bratu_continuation():
    """p scales λ: ⟨w, u*⟩ at λ = 6.5 (near the fold at 6.808), the sweep
    with a NewtonRaphson inner, abstol 1e-8."""
    w = W[:N * N].reshape(N, N)

    def jloss(p):
        u = jnls.solve(jnls.HomotopyProblem(Hp_j, jnp.zeros((N, N)), p,
                                            lambdaspan=(0.0, 6.5)),
                       jnls.HomotopySweep(inner=jnls.NewtonRaphson()),
                       abstol=1e-8).u
        return jnp.sum(jnp.asarray(w) * u)

    def tloss(p):
        u = tnls.solve(tnls.HomotopyProblem(
            Hp_t, torch.zeros((N, N), dtype=torch.float64), p,
            lambdaspan=(0.0, 6.5)),
            tnls.HomotopySweep(inner=tnls.NewtonRaphson()), abstol=1e-8).u
        return (torch.as_tensor(w) * u).sum()

    p = t64(1.0).requires_grad_(True)
    g, = torch.autograd.grad(tloss(p), p)
    with fwAD.dual_level():
        tt = fwAD.unpack_dual(tloss(fwAD.make_dual(t64(1.0), t64(1.0))))
    _close(g, jax.grad(jloss)(1.0))
    _close(tt.tangent, jax.jvp(jloss, (1.0,), (1.0,))[1])


def test_gradient_through_bratu_scc_chain():
    """Bratu N² at λ = p, a linear block J(u₁*) x = −e^{u₁*} (du/dλ), and
    a homotopy block at λ·(p + mean u₁*): ∂⟨w, u⟩/∂p by reverse and
    forward mode through the three blocks."""
    def jchain(p):
        def A(q):
            return jax.jacfwd(lambda v: jbratu(v.reshape(N, N), q[1])
                              .reshape(-1))(q[0].reshape(-1))
        z = jnp.zeros((N, N))
        return jnls.SCCNonlinearProblem(
            [jnls.NonlinearProblem(jbratu, z, p),
             jnls.LinearSCCBlock(A=A, b=lambda q: -jnp.exp(q[0]).reshape(-1)),
             jnls.HomotopyProblem(Hp_j, z, None)],
            explicitfuns=[None, lambda q, sols: (sols[0].u, q),
                          lambda q, sols: q + jnp.mean(sols[0].u)], p=p)

    def tchain(p):
        def A(q):
            return tjacfwd(lambda v: tbratu(v.reshape(N, N), q[1])
                           .reshape(-1))(q[0].reshape(-1))
        z = torch.zeros((N, N), dtype=torch.float64)
        return tnls.SCCNonlinearProblem(
            [tnls.NonlinearProblem(tbratu, z, p),
             tnls.LinearSCCBlock(A=A, b=lambda q: -torch.exp(q[0])
                                 .reshape(-1)),
             tnls.HomotopyProblem(Hp_t, z, None)],
            explicitfuns=[None, lambda q, sols: (sols[0].u, q),
                          lambda q, sols: q + sols[0].u.mean()], p=p)

    def jloss(p):
        sol = jnls.solve(jchain(p), jnls.SCCAlg(nlalg=jnls.NewtonRaphson()),
                         abstol=1e-10)
        return jnp.sum(jnp.asarray(W) * sol.u)

    def tloss(p):
        sol = tnls.solve(tchain(p), tnls.SCCAlg(nlalg=tnls.NewtonRaphson()),
                         abstol=1e-10)
        return (torch.as_tensor(W) * sol.u).sum(), sol

    jsol = jnls.solve(jchain(3.5), jnls.SCCAlg(nlalg=jnls.NewtonRaphson()),
                      abstol=1e-10)
    p = t64(3.5).requires_grad_(True)
    loss, tsol = tloss(p)
    assert tsol.retcode == tnls.ReturnCode.Success
    assert int(jsol.retcode) == int(tsol.retcode)
    assert tsol.stats == tnls.NLStats(*[int(getattr(jsol.stats, k)) for k in (
        "nf", "njacs", "nfactors", "nsolve", "nsteps")])
    np.testing.assert_allclose(tsol.u.detach().numpy(), np.asarray(jsol.u),
                               rtol=0, atol=1e-10)
    g, = torch.autograd.grad(loss, p)
    with fwAD.dual_level():
        tt = fwAD.unpack_dual(tloss(fwAD.make_dual(t64(3.5), t64(1.0)))[0])
    _close(g, jax.grad(jloss)(3.5))
    _close(tt.tangent, jax.jvp(jloss, (3.5,), (1.0,))[1])

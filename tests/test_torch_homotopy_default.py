"""The default continuation against the JAX package: ``solve(prob)`` and
``HomotopyPolyAlgorithm()`` (the sweep, then arclength with the warm
handoff), and the default inner corrector (the FastShortcut
polyalgorithm, whose winning rung at the anchor warm-starts every
tracking solve), f64 on the CPU.

Each JAX plan with the default inner costs about 10 s of compile (more
under a loaded test run), so the JAX package runs it in two cases of
``tests/test_homotopy_scc.py``: the cubic (``HomotopyPolyAlgorithm()``
and no algorithm, one plan) and the n = 50 retention case.  The
two-unknown system and the fold that the sweep cannot pass and arclength
rounds compare the staged polyalgorithm with NewtonRaphson inners in both
packages (the warm handoff included), and the port alone runs them with
the default inner against the JAX test's assertions.  Retcode and
``NLStats`` equal to the JAX package's, roots within 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu_torch as tnls
from test_torch_homotopy import H_cubic, assert_same, both, t64

torch.set_num_threads(1)


def poly(m):
    return m.HomotopyPolyAlgorithm()


def nr_stages(m):
    return m.HomotopyPolyAlgorithm(stages=(
        m.HomotopySweep(inner=m.NewtonRaphson()),
        m.ArcLengthContinuation(inner=m.NewtonRaphson())))


def test_homotopy_cubic_default():
    """``HomotopyPolyAlgorithm()`` and no algorithm: one JAX plan."""
    for alg in (poly, None):
        jsol, tsol = both(H_cubic, [0.0], jnp.array(3.0), alg)
        assert_same(jsol, tsol)
        assert tsol.success and abs(float(tsol.u[0]) - 1.0) <= 1e-8


def H_multi_j(u, p, lam):
    target = jnp.array([u[0] ** 2 + u[1] ** 2 - 2.0,
                        jnp.exp(u[0] - 1.0) + u[1] ** 3 - 2.0])
    return lam * target + (1 - lam) * (u - jnp.array([0.8, 0.8]))


def H_multi_t(u, p, lam):
    target = torch.stack([u[0] ** 2 + u[1] ** 2 - 2.0,
                          torch.exp(u[0] - 1.0) + u[1] ** 3 - 2.0])
    return lam * target + (1 - lam) * (u - torch.tensor([0.8, 0.8],
                                                        dtype=u.dtype))


def test_homotopy_multidim():
    jsol, tsol = both(H_multi_j, [0.0, 0.0], None, nr_stages, Ht=H_multi_t)
    assert_same(jsol, tsol)
    port = tnls.solve(tnls.HomotopyProblem(H_multi_t, t64([0.0, 0.0])))
    for sol in (tsol, port):
        assert sol.success
        np.testing.assert_allclose(sol.u.numpy(), [1.0, 1.0], atol=1e-6)


def H_sfold_low(u, p, lam):
    return u ** 3 - u - 2.0 * lam + 0.3


def test_homotopy_fold_polyalg_recovers():
    """The natural-parameter branch folds; the staged polyalgorithm still
    lands a root at λ = 1."""
    jsol, tsol = both(H_sfold_low, [0.3], None, nr_stages)
    assert_same(jsol, tsol)
    port = tnls.solve(tnls.HomotopyProblem(H_sfold_low, t64([0.3])))
    for sol in (tsol, port):
        assert sol.success
        assert abs(float(H_sfold_low(sol.u, None, 1.0)[0])) < 1e-8


N_RETAIN = 50
C_RETAIN = np.array([2.0 + 0.25 * (i > 0) + 0.25 * (i < N_RETAIN - 1)
                     for i in range(N_RETAIN)])


def H_retain_j(u, p, lam):
    coup = (0.25 * jnp.roll(u, 1).at[0].set(0.0)
            + 0.25 * jnp.roll(u, -1).at[-1].set(0.0))
    return u + coup + lam * u ** 3 - jnp.asarray(C_RETAIN)


def H_retain_t(u, p, lam):
    z = u.new_zeros(1)
    coup = 0.25 * torch.cat([z, u[:-1]]) + 0.25 * torch.cat([u[1:], z])
    return u + coup + lam * u ** 3 - torch.as_tensor(C_RETAIN)


def test_sweep_polyalg_inner_retention_economy():
    """With the winning rung retained, the default inner stays within 3×
    a Newton inner's residual count (93 against 42 in both packages)."""
    jd, td = both(H_retain_j, np.ones(N_RETAIN), None,
                  lambda m: m.HomotopySweep(), Ht=H_retain_t)
    jn, tn = both(H_retain_j, np.ones(N_RETAIN), None,
                  lambda m: m.HomotopySweep(inner=m.NewtonRaphson()),
                  Ht=H_retain_t)
    assert_same(jd, td)
    assert_same(jn, tn)
    assert td.success and tn.success
    np.testing.assert_allclose(td.u.numpy(), 1.0, atol=1e-6)
    assert td.stats.nf < 3.0 * tn.stats.nf


def test_default_is_the_staged_polyalgorithm():
    """``solve(HomotopyProblem)`` with no algorithm runs
    ``HomotopyPolyAlgorithm()``: the sweep, then arclength, each with the
    FastShortcut inner; ``FastShortcutHomotopyPolyalg`` is that ladder."""
    alg = tnls.HomotopyPolyAlgorithm()
    assert [type(s).__name__ for s in alg.stages] == [
        "HomotopySweep", "ArcLengthContinuation"]
    assert alg.warm_handoff and all(s.inner is None for s in alg.stages)
    fs = tnls.FastShortcutHomotopyPolyalg(warm_handoff=False)
    assert not fs.warm_handoff
    assert [a.name for a in fs.stages[0].inner.algs] == [
        a.name for a in tnls.FastShortcutNonlinearPolyalg().algs]
    prob = tnls.HomotopyProblem(H_cubic, t64([0.0]), t64(3.0))
    a, b = tnls.solve(prob), tnls.solve(prob, fs)
    assert torch.equal(a.u, b.u) and a.stats == b.stats
    with pytest.raises(ValueError, match="cannot dispatch"):
        tnls.solve(prob, tnls.NewtonRaphson())

"""Complex states under the engines that order values (ROADMAP A.33's
rest) against the JAX package, complex128 on the CPU.

- ``utils/ordering.py`` on seeded complex arrays with tied real parts:
  ``amax`` / ``amin`` (whole and along an axis), ``maximum`` /
  ``minimum``, ``greater`` / ``less`` equal ``jnp.max``, ``jnp.min``,
  ``jnp.maximum``, ``jnp.minimum``, ``>``, ``>=``, ``<``, ``<=``;
- every trust-region radius scheme on u³ − 8 from −0.8 + 1.5i: the JAX
  package's retcode, NLStats and root (the schemes that start from a real
  radius, NLsolve and Fan, fail to trace in the JAX package and are
  refused by the port);
- the Dogleg's complex radius on a two-unknown system whose max(u) −
  min(u) has an imaginary part, and LevenbergMarquardt on it;
- the complex N = 8 Brusselator under TrustRegion against the JAX package
  and against the real f64 solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.utils import ordering

torch.set_num_threads(1)

C128 = torch.complex128


def _stats(sol):
    s = sol.stats
    return [int(s.nf), int(s.njacs), int(s.nfactors), int(s.nsolve),
            int(s.nsteps)]


def _seeded(shape, seed):
    rng = np.random.default_rng(seed)
    re = rng.integers(-2, 3, shape).astype(np.float64)   # many ties
    return re + 1j * rng.standard_normal(shape)


def test_ordering_helpers_follow_jax():
    a, b = _seeded((6, 5), 0), _seeded((6, 5), 1)
    ta, tb = torch.tensor(a), torch.tensor(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    assert complex(ordering.amax(ta)) == complex(jnp.max(ja))
    assert complex(ordering.amin(ta)) == complex(jnp.min(ja))
    for d in (0, 1, -1):
        np.testing.assert_array_equal(ordering.amax(ta, d).numpy(),
                                      np.asarray(jnp.max(ja, axis=d)))
        np.testing.assert_array_equal(ordering.amin(ta, d).numpy(),
                                      np.asarray(jnp.min(ja, axis=d)))
    np.testing.assert_array_equal(ordering.maximum(ta, tb).numpy(),
                                  np.asarray(jnp.maximum(ja, jb)))
    np.testing.assert_array_equal(ordering.minimum(ta, tb).numpy(),
                                  np.asarray(jnp.minimum(ja, jb)))
    for got, want in (
            (ordering.greater(ta, tb), ja > jb),
            (ordering.greater(ta, tb, or_equal=True), ja >= jb),
            (ordering.less(ta, tb), ja < jb),
            (ordering.less(ta, tb, or_equal=True), ja <= jb),
            (ordering.greater(ta.real, 0.5 + 0.25j), ja.real > 0.5 + 0.25j),
            (ordering.maximum(ta.real, 1.0 + 0.5j),
             jnp.maximum(ja.real, 1.0 + 0.5j))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # utils/ordering.py's own examples; real operands stay plain ops
    assert complex(ordering.amax(torch.tensor([1 + 5j, 2 - 1j, 2 + 3j]))) \
        == 2 + 3j
    assert bool(ordering.greater(torch.tensor(1 + 2j), 1 + 1j))
    x = torch.tensor([1.0, -2.0, 3.0])
    assert torch.equal(ordering.maximum(x, 0.0), torch.clamp(x, min=0.0))
    assert float(ordering.amax(x)) == 3.0


@pytest.mark.parametrize("scheme", ["simple", "nocedalwright", "hei", "yuan",
                                    "bastin", "nlsolve", "fan"])
def test_trust_region_schemes_on_the_complex_cubic(scheme):
    jprob = jnls.NonlinearProblem(lambda u, p: u ** 3 - p,
                                  jnp.array([-0.8 + 1.5j], jnp.complex128),
                                  8.0 + 0j)
    tprob = tnls.NonlinearProblem(lambda u, p: u ** 3 - p,
                                  torch.tensor([-0.8 + 1.5j], dtype=C128),
                                  8.0)
    jalg = jnls.TrustRegion(radius_update_scheme=scheme)
    talg = tnls.TrustRegion(radius_update_scheme=scheme)
    if scheme in ("nlsolve", "fan"):
        with pytest.raises(TypeError, match="carry"):
            jnls.solve(jprob, jalg)
        with pytest.raises(NotImplementedError, match="fails to trace"):
            tnls.solve(tprob, talg)
        return
    jsol, tsol = jnls.solve(jprob, jalg), tnls.solve(tprob, talg)
    assert int(tsol.retcode) == int(jsol.retcode)
    assert _stats(tsol) == _stats(jsol)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["TrustRegion", "LevenbergMarquardt",
                                  "SimpleTrustRegion", "SimpleDFSane"])
def test_complex_radius_with_an_imaginary_part(name):
    """Two unknowns whose max(u) − min(u) (lexicographic) has a real part
    above ‖F(u0)‖ and an imaginary part: the simple schemes' maximum
    radius is then that complex spread, and every comparison of the
    radius follows JAX's order."""
    def jf(u, p):
        return jnp.stack([u[0] ** 2 + 0.2 * u[1] - 1.0,
                          u[1] ** 2 - 0.3 * u[0] + 0.1j])

    def tf(u, p):
        return torch.stack([u[0] ** 2 + 0.2 * u[1] - 1.0,
                            u[1] ** 2 - 0.3 * u[0] + 0.1j])

    u0 = np.array([0.9 + 0.05j, -0.1 + 0.4j])
    spread = complex(ordering.amax(torch.tensor(u0))
                     - ordering.amin(torch.tensor(u0)))
    fnorm = float(torch.linalg.vector_norm(tf(torch.tensor(u0), None)))
    assert spread.real > fnorm and spread.imag != 0.0
    jfun = jnls.NonlinearFunction(f=jf, jac=lambda u, p: jnp.array(
        [[2 * u[0], 0.2 + 0j], [-0.3 + 0j, 2 * u[1]]]))
    jsol = jnls.solve(jnls.NonlinearProblem(jfun, jnp.asarray(u0)),
                      getattr(jnls, name)())
    tsol = tnls.solve(tnls.NonlinearProblem(tf, torch.tensor(u0)),
                      getattr(tnls, name)())
    assert int(tsol.retcode) == int(jsol.retcode)
    assert _stats(tsol) == _stats(jsol)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-12)


def test_complex_brusselator_under_trust_region():
    """The N = 8 Brusselator on a complex128 state (u0 plus 1e-3·i times
    a seeded field) under TrustRegion: the JAX package's retcode and
    NLStats, the JAX root within 1e-12, the real part at the real f64
    root and the imaginary part gone."""
    N = 8
    u0 = np.asarray(jbru.init_u0(N))
    pert = np.random.default_rng(0).standard_normal(u0.shape)
    xy = jnp.linspace(0.0, 1.0, N, dtype=jnp.float64)
    force = 5.0 * (((xy[:, None] - 0.3) ** 2 + (xy[None, :] - 0.6) ** 2)
                   <= 0.01).astype(jnp.float64)

    def jf(U, p):                   # the real grid's forcing mask
        alpha = p[2] / p[3] ** 2
        u, v = U[..., 0], U[..., 1]

        def lap(w):
            return (jnp.roll(w, 1, 0) + jnp.roll(w, -1, 0)
                    + jnp.roll(w, 1, 1) + jnp.roll(w, -1, 1) - 4.0 * w)
        du = (alpha * lap(u) + p[1] + u * u * v - (p[0] + 1.0) * u
              + force.astype(U.dtype))
        dv = alpha * lap(v) + p[0] * u - u * u * v
        return jnp.stack([du, dv], axis=-1)

    jp = jbru.default_p(N)
    jsol = jnls.solve(jnls.NonlinearProblem(
        jf, jnp.asarray(u0 + 1e-3j * pert), jp), jnls.TrustRegion(),
        abstol=1e-10)
    tp = tbru.default_p(N, device="cpu")
    treal = tnls.solve(tnls.NonlinearProblem(tbru.brusselator_2d,
                                             torch.tensor(u0), tp),
                       tnls.TrustRegion(), abstol=1e-10)
    tsol = tnls.solve(tnls.NonlinearProblem(
        tbru.brusselator_2d, torch.tensor(u0 + 1e-3j * pert), tp),
        tnls.TrustRegion(), abstol=1e-10)
    assert int(tsol.retcode) == int(jsol.retcode) == 1
    assert _stats(tsol) == _stats(jsol)
    np.testing.assert_allclose(tsol.u.numpy(), np.asarray(jsol.u), rtol=0,
                               atol=1e-12)
    assert float((tsol.u.real - treal.u).abs().max()) < 1e-10
    assert float(tsol.u.imag.abs().max()) < 1e-10

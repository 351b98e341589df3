"""Port model and preconditioner against the JAX package: the Brusselator
residual (models/brusselator.py) and the FFT Poisson preconditioner
(ops/preconditioners.py), on the same seeded numpy inputs.

The forcing disk's edge sits at ulp level: its count is held exactly
(7 forced points at N=16, 8204 at N=512, in f32 and f64).  Values: f64
rtol 1e-12 (same operations), f32 rtol 1e-6 of max|F| (sum order).  The
preconditioner: f64 rtol 1e-12 (the FFT libraries differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinearsolve_tpu.models import brusselator as jbru
from nonlinearsolve_tpu.ops import preconditioners as jpre
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.ops import preconditioners as tpre

torch.set_num_threads(2)

JNP = {"float32": jnp.float32, "float64": jnp.float64}
TORCH = {"float32": torch.float32, "float64": torch.float64}
RTOL = {"float64": 1e-12, "float32": 1e-6}
FORCED = {16: 7, 512: 8204}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N", [16, 512])
def test_forcing_mask_matches_jax_exactly(N, dtype):
    # At U = 0 the u-residual is B + 5·mask exactly: 1 or 6.
    jres = np.asarray(jbru.brusselator_2d(jnp.zeros((N, N, 2), JNP[dtype]),
                                          jbru.default_p(N, JNP[dtype])))
    tres = tbru.brusselator_2d(
        torch.zeros((N, N, 2), dtype=TORCH[dtype]),
        tbru.default_p(N, TORCH[dtype], device="cpu")).numpy()
    assert int((jres[..., 0] > 3).sum()) == FORCED[N]
    assert int((tres[..., 0] > 3).sum()) == FORCED[N]
    assert int(tbru.forcing_mask(N, TORCH[dtype]).sum()) == FORCED[N]
    np.testing.assert_array_equal(tres, jres)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N", [12, 16, 32, 512, 2048])
def test_grid_is_jnp_linspace(N, dtype):
    np.testing.assert_array_equal(
        tbru.grid(N, TORCH[dtype]),
        np.asarray(jnp.linspace(0.0, 1.0, N, dtype=JNP[dtype])))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("N", [16, 512])
def test_residual_at_u0_matches_jax(N, dtype):
    ju0 = jbru.init_u0(N, JNP[dtype])
    tu0 = tbru.init_u0(N, TORCH[dtype], device="cpu")
    np.testing.assert_array_equal(tu0.numpy(), np.asarray(ju0))
    np.testing.assert_array_equal(
        tbru.default_p(N, TORCH[dtype], device="cpu").numpy(),
        np.asarray(jbru.default_p(N, JNP[dtype])))
    ref = np.asarray(jbru.brusselator_2d(ju0, jbru.default_p(N, JNP[dtype])))
    got = tbru.brusselator_2d(
        tu0, tbru.default_p(N, TORCH[dtype], device="cpu")).numpy()
    scale = np.abs(ref).max()
    assert np.abs(got.astype(np.float64) - ref).max() <= RTOL[dtype] * scale


def test_residual_on_random_state_matches_jax():
    N = 24
    rng = np.random.default_rng(7)
    U = rng.standard_normal((N, N, 2))
    p = np.asarray(jbru.default_p(N, jnp.float64))
    ref = np.asarray(jbru.brusselator_2d(jnp.asarray(U), jnp.asarray(p)))
    got = tbru.brusselator_2d(torch.tensor(U), torch.tensor(p)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_kernel_jvp_is_the_residuals_derivative():
    """make_problem(kernel_jvp=True)'s jvp equals torch.func.jvp of the
    residual (f64)."""
    N = 16
    prob = tbru.make_problem(N, torch.float64, kernel_jvp=True, device="cpu")
    T = torch.tensor(np.random.default_rng(8).standard_normal((N, N, 2)))
    ad = torch.func.jvp(lambda U: tbru.brusselator_2d(U, prob.p),
                        (prob.u0,), (T,))[1]
    got = prob.f.jvp(T, prob.u0, prob.p)
    np.testing.assert_allclose(got.numpy(), ad.numpy(), rtol=1e-10,
                               atol=1e-8)


@pytest.mark.parametrize("N", [16, 32])
def test_fft_symbol_matches_jax(N):
    ref = np.asarray(jpre.fft_poisson_symbol((N, N), 10.0, 1.0 / (N - 1),
                                             3.0, jnp.float64))
    got = tpre.fft_poisson_symbol((N, N), 10.0, 1.0 / (N - 1), 3.0,
                                  torch.float64, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_fft_symbol_defaults_to_the_card():
    """device=None means the card, as for every entry point: without CUDA
    it raises instead of building the symbol on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpre.fft_poisson_symbol((8, 8), 10.0, 1.0 / 7, 3.0, torch.float64)
    assert tpre.fft_poisson_symbol((8, 8), 10.0, 1.0 / 7,
                                   device="cpu").device.type == "cpu"


@pytest.mark.parametrize("shaped", [True, False])
@pytest.mark.parametrize("n_components", [1, 2])
@pytest.mark.parametrize("N", [16, 32])
def test_fft_poisson_preconditioner_matches_jax(N, n_components, shaped):
    h = 1.0 / (N - 1)
    shape = (N, N, n_components) if n_components > 1 else (N, N)
    v = np.random.default_rng(N + n_components).standard_normal(shape)
    if not shaped:
        v = v.reshape(-1)
    jM = jpre.fft_poisson_preconditioner((N, N), alpha=10.0, h=h, shift=3.0,
                                         n_components=n_components)
    tM = tpre.fft_poisson_preconditioner((N, N), alpha=10.0, h=h, shift=3.0,
                                         n_components=n_components)
    ref = np.asarray(jM(jnp.asarray(v)))
    got = tM(torch.tensor(v))
    assert tuple(got.shape) == v.shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_fft_preconditioner_three_components_rfft_route():
    N = 16
    v = np.random.default_rng(9).standard_normal((N, N, 3))
    kw = dict(alpha=10.0, h=1.0 / (N - 1), shift=3.0, n_components=3)
    ref = np.asarray(jpre.fft_poisson_preconditioner((N, N), **kw)(
        jnp.asarray(v)))
    got = tpre.fft_poisson_preconditioner((N, N), **kw)(torch.tensor(v))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


def test_fft_preconditioner_f32_keeps_dtype():
    N = 16
    v = np.random.default_rng(10).standard_normal((N, N, 2))
    kw = dict(alpha=10.0, h=1.0 / (N - 1), shift=3.0, n_components=2)
    ref = np.asarray(jpre.fft_poisson_preconditioner((N, N), **kw)(
        jnp.asarray(v, jnp.float32)))
    got = tpre.fft_poisson_preconditioner((N, N), **kw)(
        torch.tensor(v, dtype=torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())

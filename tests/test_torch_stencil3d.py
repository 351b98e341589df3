"""K9 (``rd3d_jvp_blocked``) and K10 (``rd3d_jvp_scaled``) of the port on the
CPU — their plain PyTorch versions, which the wrappers take for CPU tensors —
against the JAX package's Pallas kernels in interpret mode, on the same
seeded numpy inputs.

Tolerances: f64 atol 1e-11 (the same operations in the same order; the
JAX package's own test holds its kernel to that against ``jax.jvp``), f32
rel-inf 1e-5 of max|out|; the absmax rtol 1e-12 (f64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinearsolve_tpu.ops import pallas_stencil3d as jst
from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.ops import stencil3d as tst

torch.set_num_threads(2)

D = 0.01
SHAPES = {"cube16": (16, 16, 16), "box8x12x16": (8, 12, 16)}


def _inputs(shape, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    u = (0.1 + 0.5 * rng.standard_normal(shape)).astype(dtype)
    t = rng.standard_normal(shape).astype(dtype)
    return u, t


def _close_f32(got, ref):
    ref = np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(np.asarray(got, np.float64) - ref).max() <= 1e-5 * scale


@pytest.mark.parametrize("double_buffer", [False, True])
@pytest.mark.parametrize("bz", [4, 8])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_k9_matches_jax_f64(shape, bz, double_buffer):
    u, t = _inputs(SHAPES[shape], bz)
    ref = np.asarray(jst.rd3d_jvp_blocked(jnp.asarray(u), jnp.asarray(t), D,
                                          bz=bz, double_buffer=double_buffer))
    got = tst.rd3d_jvp_blocked(torch.tensor(u), torch.tensor(t), D, bz=bz,
                               double_buffer=double_buffer)
    assert got.dtype == torch.float64 and tuple(got.shape) == u.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-11)


@pytest.mark.parametrize("shape", list(SHAPES))
def test_k9_matches_jax_f32_with_a_tensor_d(shape):
    """f32, D as a 0-d array / tensor in the state's dtype (the solve's
    case: ``p[0]``)."""
    u, t = _inputs(SHAPES[shape], 11, np.float32)
    ref = jst.rd3d_jvp_blocked(jnp.asarray(u), jnp.asarray(t),
                               jnp.asarray(D, jnp.float32), bz=4,
                               double_buffer=True)
    got = tst.rd3d_jvp_blocked(torch.tensor(u), torch.tensor(t),
                               torch.tensor(D, dtype=torch.float32), bz=4,
                               double_buffer=True)
    assert got.dtype == torch.float32
    _close_f32(got.numpy(), ref)


@pytest.mark.parametrize("shape,bz,inv", [("cube16", 4, 0.5),
                                          ("box8x12x16", 8, 1.0)])
def test_k10_matches_jax(shape, bz, inv):
    u, t = _inputs(SHAPES[shape], 20 + bz)
    ref, mref = jst.rd3d_jvp_scaled(jnp.asarray(u), jnp.asarray(t), D, inv,
                                    bz=bz)
    got, m = tst.rd3d_jvp_scaled(torch.tensor(u), torch.tensor(t), D, inv,
                                 bz=bz)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-11)
    assert m.dim() == 0 and m.dtype == torch.float64
    np.testing.assert_allclose(float(m), float(mref), rtol=1e-12)
    # K10 is K9 times inv_scale
    np.testing.assert_allclose(
        got.numpy(), tst.rd3d_jvp_blocked_plain(
            torch.tensor(u), torch.tensor(t), D).numpy() * inv,
        rtol=0, atol=1e-11)


def test_k10_inv_scale_tensor_f32():
    u, t = _inputs(SHAPES["box8x12x16"], 31, np.float32)
    ref, mref = jst.rd3d_jvp_scaled(jnp.asarray(u), jnp.asarray(t),
                                    jnp.asarray(D, jnp.float32), 0.25, bz=4)
    got, m = tst.rd3d_jvp_scaled(torch.tensor(u), torch.tensor(t),
                                 torch.tensor(D, dtype=torch.float32),
                                 torch.tensor(0.25), bz=4)
    assert got.dtype == m.dtype == torch.float32
    _close_f32(got.numpy(), ref)
    np.testing.assert_allclose(float(m), float(mref), rtol=1e-6)


def test_k10_absmax_propagates_nan():
    u, t = _inputs(SHAPES["cube16"], 5)
    t[3, 7, 11] = np.nan
    _, m = tst.rd3d_jvp_scaled(torch.tensor(u), torch.tensor(t), D, 0.5,
                               bz=4)
    _, mref = jst.rd3d_jvp_scaled(jnp.asarray(u), jnp.asarray(t), D, 0.5,
                                  bz=4)
    assert np.isnan(float(m)) and np.isnan(float(mref))


@pytest.mark.parametrize("shape,bz", [((16, 16, 16), 5), ((8, 12, 16), 16),
                                      ((12, 8, 8), 8)])
def test_bz_must_divide_nz(shape, bz):
    u, t = (torch.tensor(a) for a in _inputs(shape, 0))
    with pytest.raises(ValueError, match="must divide"):
        tst.rd3d_jvp_blocked(u, t, D, bz=bz)
    with pytest.raises(ValueError, match="must divide"):
        tst.rd3d_jvp_scaled(u, t, D, 1.0, bz=bz)
    with pytest.raises(ValueError, match="must divide"):
        jst.rd3d_jvp_blocked(jnp.asarray(u.numpy()), jnp.asarray(t.numpy()),
                             D, bz=bz)


def test_cpu_path_launches_no_kernel():
    before = dict(_backend.LAUNCHES)
    u, t = (torch.tensor(a) for a in _inputs((8, 8, 8), 1))
    tst.rd3d_jvp_blocked(u, t, D, bz=4)
    tst.rd3d_jvp_scaled(u, t, D, 0.5, bz=8)
    assert _backend.LAUNCHES == before

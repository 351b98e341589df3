"""Models of the redesigned K2 and K3 (csrc/stencil.cu) on the CPU, against
the plain versions and the JAX package, so the algebra holds before the card
runs it (the kernels themselves are held to the plain versions on the card
in tests/test_torch_cuda.py and chip_smoke.py).

- K3 computes on bf16x2 pairs with rewritten operands: (2uv, u²) as
  ((u, u)·(2, 1))·(v, u), the coefficients as one pair subtraction
  (2uv, A) − (A+1, 2uv), and the last term as (w, −w) added.  A torch model
  of that order, one bf16 op per pair op, is bit-equal (a NaN matching any
  NaN) to ``brusselator_jvp_bf16_plain`` on seeded inputs and on edge
  values: ±0, values near the bf16 maximum that overflow to ±inf, bf16
  subnormals (tangents and results), mixed signs.  Tolerance 0: every op
  of both rounds to bf16 at once, and RN(a + (−b)) = RN(a − b).
- K3's f32-tangent variant: the bf16 matvec's CPU path on an f32 tangent is
  cast → K3's plain version → cast bit for bit (bf16 tangent: K3's plain
  version; f64 keeps its dtype), and agrees with the JAX matvec bit for bit
  on seeded inputs, as ``test_torch_mixed_precision.py`` holds K3.
- K2 reduces its max in two levels on the bit patterns of |out|: a partial
  a block (one block a 32x8 tile), then one atomicMax a block into a word
  zeroed before the launch.  An algebra model of that order (the blocks'
  atomics in several orders) equals ``torch.max(torch.abs(out))``, NaN and
  ±inf included.  The kernel itself is held to its own output's max on the
  card.
- On the CPU a Python-float and a 0-d tensor ``inv_scale`` give the same
  bits through the plain version (the kernel's two routes for it are held
  to each other on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonlinearsolve_tpu.ops import pallas_stencil as jst
from nonlinearsolve_tpu_torch.ops import stencil as tst

torch.set_num_threads(2)

BF = torch.bfloat16
_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
         torch.float64: torch.int64}
# ±0, values near the bf16 maximum (sums and products overflow to ±inf,
# and inf - inf gives NaN), bf16 subnormals, and mixed signs
EDGE_POOL = [0.0, -0.0, 3.3e38, -3.3e38, 1.7e38, -2.6e38, 1e-39, -1e-39,
             9.2e-41, -9.2e-41, 1.0, -1.0, 2.0, 0.5]


def _bit_equal(a, b):
    """Equal bit for bit (so -0 is not +0); a NaN matches any NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.view(_BITS[a.dtype])[~na], b.view(_BITS[b.dtype])[~nb]))


def _inputs(N, seed, mode="normal"):
    """U, T (N, N, 2) f32 and p f32 from a seed: normals (T × 10).  "edges":
    a fifth of the values drawn from EDGE_POOL.  "tiny": T × 1e-38 (bf16
    subnormals) with a fifth ±0, and al = 1e-3, so products and sums land
    in the subnormal range."""
    rng = np.random.default_rng(seed)

    def one(scale, pool):
        x = rng.standard_normal((N, N, 2)) * scale
        if pool:
            mask = rng.random((N, N, 2)) < 0.2
            x[mask] = rng.choice(pool, int(mask.sum()))
        return x.astype(np.float32)

    pool = EDGE_POOL if mode == "edges" else [0.0, -0.0] * (mode == "tiny")
    U = one(1.0, pool)
    T = one(1e-38 if mode == "tiny" else 10.0, pool)
    p = np.array([3.4, 1.0, 1e-3 if mode == "tiny" else 10.0,
                  1.0 if mode == "tiny" else 1.0 / max(N - 1, 1)],
                 np.float32)
    return U, T, p


def _k3_pair_model(U, T, p):
    """K3's bf16x2 order (``k3_point``) in torch: each op on (..., 2) bf16
    pairs, each lane rounded to bf16 as the kernel's .rn pair op."""
    al, ap1, A = tst._scalars_bf16(p)

    def pair(a, b):
        return torch.stack([a, b], -1)

    def both(x):
        return pair(x, x)

    u, v = U[..., 0], U[..., 1]
    tu, tv = T[..., 0], T[..., 1]
    lap = ((((torch.roll(T, 1, 0) + torch.roll(T, -1, 0))
             + torch.roll(T, 1, 1)) + torch.roll(T, -1, 1))
           - torch.tensor([4.0, 4.0], dtype=BF) * T)
    pp = (both(u) * torch.tensor([2.0, 1.0], dtype=BF)) * pair(v, u)
    two_uv, u2 = pp[..., 0], pp[..., 1]
    c = pair(two_uv, A.expand_as(u)) - pair(ap1.expand_as(u), two_uv)
    w = both(u2) * pair(tv, -tv)
    return (both(al.expand_as(u)) * lap + c * both(tu)) + w


@pytest.mark.parametrize("mode", ["normal", "edges", "tiny"])
@pytest.mark.parametrize("N,seed", [(1, 0), (2, 1), (3, 2), (8, 3), (37, 4),
                                    (37, 5), (64, 6)])
def test_k3_pair_model_is_bit_equal_to_plain(N, seed, mode):
    U, T, p = (torch.tensor(a) for a in _inputs(N, seed, mode))
    Ub, Tb = U.to(BF), T.to(BF)
    model = _k3_pair_model(Ub, Tb, p)
    plain = tst.brusselator_jvp_bf16_plain(Ub, Tb, p)
    assert model.dtype == plain.dtype == BF
    assert _bit_equal(model, plain)
    if N >= 37 and mode == "edges":
        # overflow to ±inf, and inf - inf
        assert torch.isinf(plain.float()).any()
        assert torch.isnan(plain.float()).any()
    if N >= 37 and mode == "tiny":
        mag = plain.float().abs()
        assert ((mag > 0) & (mag < 1.1754944e-38)).any()       # subnormal
        assert (plain.view(torch.int16) == -32768).any()       # -0


@pytest.mark.parametrize("mode", ["normal", "edges", "tiny"])
@pytest.mark.parametrize("N", [1, 3, 16, 37])
def test_bf16_matvec_cpu_path_is_cast_k3_cast(N, mode):
    U, T, p = (torch.tensor(a) for a in _inputs(N, 10 + N, mode))
    mv = tst.make_brusselator_jvp_bf16(U, p)
    ref = tst.brusselator_jvp_bf16_plain(U.to(BF), T.to(BF), p)
    out = mv(T)
    assert out.dtype == torch.float32 and _bit_equal(out, ref.float())
    assert _bit_equal(tst.brusselator_jvp_bf16_f32(U.to(BF), T, p),
                      ref.float())
    out_b = mv(T.to(BF))
    assert out_b.dtype == BF and _bit_equal(out_b, ref)
    out64 = mv(T.double())
    assert out64.dtype == torch.float64 and _bit_equal(out64, ref.double())


@pytest.mark.parametrize("N,seed", [(16, 0), (32, 1)])
def test_bf16_matvec_f32_tangent_matches_jax(N, seed):
    U, T, p = _inputs(N, seed)
    jout = np.asarray(jst.make_brusselator_jvp_bf16(
        jnp.asarray(U), jnp.asarray(p))(jnp.asarray(T)))
    tout = tst.brusselator_jvp_bf16_f32(torch.tensor(U).to(BF),
                                        torch.tensor(T), torch.tensor(p))
    assert tout.dtype == torch.float32
    np.testing.assert_array_equal(tout.numpy(), jout)


def _k2_tiles(N, bx=32, by=8):
    """K2's grid (csrc/stencil.cu launch_scaled): the (i0, j0) corner of
    each block's by x bx tile."""
    return [(i0, j0) for i0 in range(0, N, by) for j0 in range(0, N, bx)]


def _two_level_absmax(out, N, order, bx=32, by=8):
    """A model of K2's max of |out| (N, N, 2): each block's partial over
    its tile on the bit patterns of |out|, then the blocks' atomicMax into
    a word that starts at 0, in the block order ``order`` ("forward",
    "reverse" or a seed), as a float."""
    bits = torch.abs(out).view(_BITS[out.dtype]).to(torch.int64)
    partials = [bits[i0:i0 + by, j0:j0 + bx].max()
                for i0, j0 in _k2_tiles(N, bx, by)]
    if order == "reverse":
        partials = partials[::-1]
    elif order != "forward":
        perm = np.random.default_rng(order).permutation(len(partials))
        partials = [partials[k] for k in perm]
    word = torch.zeros((), dtype=torch.int64)
    for m in partials:
        word = torch.maximum(word, m)
    return word.to(_BITS[out.dtype]).view(out.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N,special", [(1, None), (3, "nan"), (37, "inf"),
                                       (130, "nan"), (257, "-inf"),
                                       (300, "zeros"), (512, None)])
def test_k2_two_level_max_equals_torch_max(N, special, dtype):
    rng = np.random.default_rng(N)
    out = torch.tensor(rng.standard_normal((N, N, 2)), dtype=dtype)
    if special == "zeros":
        out = torch.zeros_like(out)
        out[N // 2, N // 3, 1] = -0.0
    elif special is not None:
        out[N - 1, N // 2, 1] = float(special)
        out[0, 0, 0] = float("inf")
    ref = torch.max(torch.abs(out))
    for order in ("forward", "reverse", 7):
        assert _bit_equal(_two_level_absmax(out, N, order), ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
def test_k2_float_and_tensor_inv_scale_agree(layout, dtype):
    """The plain version's two routes for inv_scale give the same bits."""
    rng = np.random.default_rng(3)
    N = 24
    U = torch.tensor(rng.random((N, N, 2)), dtype=dtype)
    T = torch.tensor(rng.standard_normal((N, N, 2)), dtype=dtype)
    p = torch.tensor([3.4, 1.0, 10.0, 1.0 / (N - 1)], dtype=dtype)
    inv_t = torch.tensor(0.3, dtype=dtype)
    if layout == "interleaved":
        a = tst.brusselator_jvp_scaled(U, T, p, 0.3)
        b = tst.brusselator_jvp_scaled(U, T, p, inv_t)
    else:
        planes = [x[..., k].contiguous() for x in (U, T) for k in (0, 1)]
        a = tst.brusselator_jvp_scaled_pair(*planes, p, 0.3)
        b = tst.brusselator_jvp_scaled_pair(*planes, p, inv_t)
    assert all(_bit_equal(x, y) for x, y in zip(a, b))

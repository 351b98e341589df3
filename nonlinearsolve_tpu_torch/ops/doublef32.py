"""Double-word float32 ("double-f32") arithmetic for mixed-precision
iterative refinement (the port of ``ops/doublef32.py``).

A value is an unevaluated sum ``hi + lo`` of two floats of the working
dtype with ``|lo| <= ulp(hi)/2``: about 48 mantissa bits (~1e-14
relative) from f32 words, built from error-free transformations (Dekker
1971, Knuth TAOCP v2 §4.2.2 — the double-double / ``df64`` arithmetic).

Eager PyTorch runs each op as written, with one rounding an op: it does
no algebraic simplification and does not contract ``a*b + c`` into one
FMA, so the JAX package's ``optimization_barrier`` / ``select`` guards
have no counterpart here.  Two rules keep it so: never run these
functions under ``torch.compile``, and never write a DF op through
``torch.addcmul`` (a fused kernel may round once).  :func:`self_check`
checks the ``two_sum`` / ``two_prod`` invariants on a device.

The operations and their summation orders are the JAX package's, so on
the CPU the words equal its words bit for bit.  Used by
:mod:`..solvers.refinement`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _backend


class DF(NamedTuple):
    """Double-word value: unevaluated sum ``hi + lo`` (same shape/dtype)."""
    hi: torch.Tensor
    lo: torch.Tensor


def _split_constant(dtype) -> float:
    # Dekker splitting constant 2^ceil(p/2) + 1 for a p-bit mantissa.
    if dtype == torch.float64:
        return 134217729.0        # 2^27 + 1
    return 4097.0                 # f32: 2^12 + 1


def two_sum(a, b):
    """Error-free sum: (s, e) with s = fl(a+b), s + e = a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (or a == 0)."""
    s = a + b
    e = b - (s - a)
    return s, e


def two_prod(a, b):
    """Error-free product: (p, e) with p = fl(a*b), p + e = a*b exactly
    (Dekker's split; every partial product is exact)."""
    p = a * b
    dt = torch.result_type(a, b)
    c = _split_constant(dt)
    ca = c * a
    ahi = ca - (ca - a)
    alo = a - ahi
    cb = c * b
    bhi = cb - (cb - b)
    blo = b - bhi
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return p, e


# ---------------------------------------------------------------------------
# DF constructors
# ---------------------------------------------------------------------------


def df(hi, lo=None) -> DF:
    hi = torch.as_tensor(hi)
    if lo is None:
        lo = torch.zeros_like(hi)
    return DF(hi, torch.as_tensor(lo, dtype=hi.dtype, device=hi.device))


def df_from_f64(value, dtype=torch.float32, *, device=None) -> DF:
    """Split a host float64 scalar/array into an exact double-word pair
    (hi = round(value), lo = round(value - hi)) on ``device`` (the card
    when None)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    npdt = _backend.np_dtype(dtype)
    v = np.asarray(value, np.float64)
    hi = v.astype(npdt)
    lo = (v - hi.astype(np.float64)).astype(npdt)
    dev = _backend.resolve_device(device)
    return DF(torch.as_tensor(hi, device=dev), torch.as_tensor(lo, device=dev))


def df_value_f64(x: DF) -> np.ndarray:
    """Host-side f64 reconstruction (for validation off the device)."""
    return (x.hi.detach().cpu().numpy().astype(np.float64)
            + x.lo.detach().cpu().numpy().astype(np.float64))


# ---------------------------------------------------------------------------
# DF arithmetic (double-word add/mul/div — QD library "sloppy" variants,
# error O(eps^2) relative, ample for iterative-refinement defects)
# ---------------------------------------------------------------------------


def df_add(x: DF, y: DF) -> DF:
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_add_f(x: DF, b) -> DF:
    s, e = two_sum(x.hi, b)
    e = e + x.lo
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_mul_f(x: DF, b) -> DF:
    p, e = two_prod(x.hi, b)
    e = e + x.lo * b
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_div(x: DF, y: DF) -> DF:
    q1 = x.hi / y.hi
    r = df_add(x, df_neg(df_mul_f(y, q1)))
    q2 = (r.hi + r.lo) / y.hi
    hi, lo = fast_two_sum(q1, q2)
    return DF(hi, lo)


def df_roll(x: DF, shift, axis) -> DF:
    """Data movement is exact — shift both words."""
    return DF(torch.roll(x.hi, shift, axis), torch.roll(x.lo, shift, axis))


def _fold(hi, lo) -> DF:
    """The compensated pairwise fold along the last axis (padded with
    exact zeros to a power of two): log₂ k levels of df_add of halves."""
    k = hi.shape[-1]
    m = 1
    while m < k:
        m *= 2
    if m != k:
        pad = hi.new_zeros(hi.shape[:-1] + (m - k,))
        hi = torch.cat([hi, pad], dim=-1)
        lo = torch.cat([lo, pad], dim=-1)
    acc = DF(hi, lo)
    while acc.hi.shape[-1] > 1:
        half = acc.hi.shape[-1] // 2
        acc = df_add(DF(acc.hi[..., :half], acc.lo[..., :half]),
                     DF(acc.hi[..., half:], acc.lo[..., half:]))
    return DF(acc.hi[..., 0], acc.lo[..., 0])


def df_sum(x: DF) -> DF:
    """Compensated full reduction: a binary folding tree of double-word
    adds — log₂(n) vectorized levels, each a df_add of the two halves, so
    the error stays at the double-word grade (~2^-45·log n relative)."""
    return _fold(x.hi.reshape(-1), x.lo.reshape(-1))


def df_dot(x: DF, y: DF) -> DF:
    return df_sum(df_mul(x, y))


# ---------------------------------------------------------------------------
# Double-word transcendentals: argument reduction against a two-word
# constant, a Taylor kernel in DF arithmetic, an exact power-of-two rescale
# (the QD library / df64 recipes).
# ---------------------------------------------------------------------------

# two-word f64 constants (double-double literature values)
_LN2_HI64 = 0.6931471805599453
_LN2_LO64 = 2.3190468138462996e-17
_PI2_HI64 = 1.5707963267948966
_PI2_LO64 = 6.123233995736766e-17


def _df_const2(hi64: float, lo64: float, like: torch.Tensor) -> DF:
    """Two-word constant at ``like``'s dtype and device, broadcast to its
    shape: f32 pairs re-split the f64 head (keeping ~48 bits); f64 pairs
    keep the double-double tail."""
    if like.dtype == torch.float64:
        h, lo = hi64, lo64
    else:
        h32 = np.float32(hi64)
        h, lo = float(h32), float(np.float32((hi64 - float(h32)) + lo64))
    return DF(torch.full_like(like, h), torch.full_like(like, lo))


def _inv_fact_pairs(nmax: int):
    """(hi, lo) f64 pairs of 1/n! for n=0..nmax, exact via Fractions."""
    from fractions import Fraction
    out = []
    f = 1
    for n in range(nmax + 1):
        if n:
            f *= n
        q = Fraction(1, f)
        hi = float(q)
        lo = float(q - Fraction(hi))
        out.append((hi, lo))
    return out


_INV_FACT = _inv_fact_pairs(30)


def _exp2_int(k: torch.Tensor) -> torch.Tensor:
    """2^k exactly for integer-valued ``k`` (the JAX package's ldexp),
    built from the exponent bits as the product of two powers of two."""
    if k.dtype == torch.float64:
        bias, shift, lim, it = 1023, 52, 1022, torch.int64
    else:
        bias, shift, lim, it = 127, 23, 126, torch.int32
    ki = k.to(torch.int64)
    k1 = torch.div(ki, 2, rounding_mode="floor")
    k2 = ki - k1

    def p2(e):
        e = torch.clamp(e, -lim, lim + 1)
        return ((e + bias) << shift).to(it).view(k.dtype)
    return p2(k1) * p2(k2)


def df_exp(x: DF) -> DF:
    """Double-word exp: k = round(x/ln2), r = x − k·ln2 (two-word ln2),
    degree-13 (f32) / 24 (f64) Taylor Horner in DF, exact 2^k rescale."""
    ln2 = _df_const2(_LN2_HI64, _LN2_LO64, x.hi)
    k = torch.round(x.hi / ln2.hi)
    r = df_sub(x, df_mul_f(ln2, k))
    N = 24 if x.hi.dtype == torch.float64 else 13
    acc = _df_const2(*_INV_FACT[N], x.hi)
    for n in range(N - 1, -1, -1):
        acc = df_add(df_mul(acc, r), _df_const2(*_INV_FACT[n], x.hi))
    scale = _exp2_int(k)
    return DF(acc.hi * scale, acc.lo * scale)


def df_log(x: DF) -> DF:
    """Double-word log via one Newton step on df_exp: y₀ = log(hi);
    ln x = y₀ + ln(x·e^{−y₀}) with the residual ln(1+δ) summed to δ³/3."""
    y0 = torch.log(x.hi)
    e = df_exp(DF(-y0, torch.zeros_like(y0)))
    t = df_mul(x, e)                       # 1 + δ
    d = df_add_f(t, torch.full_like(x.hi, -1.0))
    d2 = df_mul(d, d)
    corr = df_add(d, df_add(df_mul_f(d2, torch.full_like(x.hi, -0.5)),
                            df_mul_f(df_mul(d2, d),
                                     torch.full_like(x.hi, 1.0 / 3.0))))
    return df_add(DF(y0, torch.zeros_like(y0)), corr)


def df_expm1(x: DF) -> DF:
    """Double-word expm1: |x| ≤ ~ln2/2 sums x·Σ xⁿ/(n+1)! (no
    1-subtraction to cancel); beyond it df_exp(x) − 1 is safe."""
    N = 24 if x.hi.dtype == torch.float64 else 13
    acc = None
    for n in range(N, -1, -1):
        c = _df_const2(*_INV_FACT[n + 1], x.hi)
        acc = c if acc is None else df_add(df_mul(acc, x), c)
    small = df_mul(x, acc)
    big = df_add_f(df_exp(x), torch.full_like(x.hi, -1.0))
    use_small = torch.abs(x.hi) <= torch.tensor(0.3466, dtype=x.hi.dtype)
    return DF(torch.where(use_small, small.hi, big.hi),
              torch.where(use_small, small.lo, big.lo))


def _inv_n_pairs(nmax: int):
    from fractions import Fraction
    out = []
    for n in range(nmax + 1):
        q = Fraction(1, n + 1)
        hi = float(q)
        lo = float(q - Fraction(hi))
        out.append((hi, lo))
    return out


_INV_N = _inv_n_pairs(30)


def df_log1p(x: DF) -> DF:
    """Double-word log1p: |x| ≤ 0.05 sums the Mercator series
    x·Σ (−x)ⁿ/(n+1) in double-word Horner; beyond it log(1+x) with the
    exact two_sum 1+x."""
    N = 24 if x.hi.dtype == torch.float64 else 13
    acc = None
    for n in range(N, -1, -1):
        hi64, lo64 = _INV_N[n]
        if n % 2 == 1:
            hi64, lo64 = -hi64, -lo64
        c = _df_const2(hi64, lo64, x.hi)
        acc = c if acc is None else df_add(df_mul(acc, x), c)
    small = df_mul(x, acc)
    big = df_log(df_add_f(x, torch.full_like(x.hi, 1.0)))
    use_small = torch.abs(x.hi) <= torch.tensor(0.05, dtype=x.hi.dtype)
    return DF(torch.where(use_small, small.hi, big.hi),
              torch.where(use_small, small.lo, big.lo))


def _df_sincos_kernel(r: DF, nterms: int):
    """Taylor sin(r), cos(r) for |r| ≤ π/4 via Horner over z = r²."""
    z = df_mul(r, r)

    def horner(coeff_idx):
        acc = None
        for n in reversed(range(nterms + 1)):
            hi64, lo64 = _INV_FACT[coeff_idx(n)]
            if n % 2 == 1:
                hi64, lo64 = -hi64, -lo64
            c = _df_const2(hi64, lo64, r.hi)
            acc = c if acc is None else df_add(df_mul(acc, z), c)
        return acc

    sin_r = df_mul(r, horner(lambda n: 2 * n + 1))
    cos_r = horner(lambda n: 2 * n)
    return sin_r, cos_r


def _df_sincos(x: DF):
    pi2 = _df_const2(_PI2_HI64, _PI2_LO64, x.hi)
    k = torch.round(x.hi / pi2.hi)
    r = df_sub(x, df_mul_f(pi2, k))
    nterms = 13 if x.hi.dtype == torch.float64 else 7
    sin_r, cos_r = _df_sincos_kernel(r, nterms)
    q = torch.remainder(k, 4.0)            # quadrant (exact float mod)

    def pick(a, b, c, d):
        hi = torch.where(q == 0, a.hi, torch.where(q == 1, b.hi,
                         torch.where(q == 2, c.hi, d.hi)))
        lo = torch.where(q == 0, a.lo, torch.where(q == 1, b.lo,
                         torch.where(q == 2, c.lo, d.lo)))
        return DF(hi, lo)

    sin_x = pick(sin_r, cos_r, df_neg(sin_r), df_neg(cos_r))
    cos_x = pick(cos_r, df_neg(sin_r), df_neg(cos_r), sin_r)
    return sin_x, cos_x


def df_sin(x: DF) -> DF:
    """Double-word sin (reduction against two-word π/2: |k|·2^-2w
    reduction error, for PDE-scale arguments)."""
    return _df_sincos(x)[0]


def df_cos(x: DF) -> DF:
    return _df_sincos(x)[1]


def self_check(device=None) -> bool:
    """two_sum / two_prod must be error-free on ``device`` (the card when
    None): catches a backend that contracts or reassociates the
    compensation terms away.  Returns True when exact."""
    dev = _backend.resolve_device(device)
    a = torch.tensor(np.float32(1.0 + 2.0 ** -12), device=dev)
    b = torch.tensor(np.float32(2.0 ** -20 + 2.0 ** -24), device=dev)
    s, e = two_sum(a, b)
    exact_sum = float(a) + float(b)
    ok_sum = float(s) + float(e) == exact_sum
    p, pe = two_prod(a, b)
    exact_prod = float(a) * float(b)
    ok_prod = float(p) + float(pe) == exact_prod
    return bool(ok_sum and ok_prod)

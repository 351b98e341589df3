"""Fused stencil JVPs of the 2D periodic Brusselator (the port of
``ops/pallas_stencil.py``'s Brusselator kernels).

K1 ``brusselator_jvp(U, T, p)`` replaces ``ops/pallas_stencil.py``
``_brusselator_jvp_kernel`` (the Jv of every GMRES iteration on the main
path).  K2 ``brusselator_jvp_scaled(U, T, p, inv_scale)`` and
``brusselator_jvp_scaled_pair(u, v, tu, tv, p, inv_scale)`` replace
``_brusselator_jvp_scaled_kernel`` (the chained, normalised matvec): the
launcher zeroes the max's word with a one-thread kernel, then K2's blocks
``atomicMax`` into it; a Python-float ``inv_scale`` goes by value (nothing
to fill).  K3
``brusselator_jvp_bf16(U, T, p)`` is K1 on bf16 state and tangent with f32
``p`` (the JAX kernel at bf16), on bf16x2 arithmetic;
``brusselator_jvp_bf16_f32(U, T, p)`` is its variant for an f32 tangent
(rounded to bf16 on read, the result widened to f32), and
``make_brusselator_jvp_bf16(U, p)`` is the JAX package's mixed-precision
matvec factory around the two.  All are CUDA C++ for ``sm_90a`` in
``csrc/stencil.cu``; that file's header says what bounds them on the H100
(bytes) and what each design does about it.

Each wrapper takes its plain PyTorch version (``*_plain``, written with
``torch.roll``) for a tensor on the CPU, and only there.  For a CUDA tensor
it checks device, dtype, shape, contiguity and alignment, launches the
kernel on the current stream and counts the launch in
``_backend.LAUNCHES``; anything the kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _backend

_VP = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "brusselator_jvp_f32": [_VP, _VP, _VP, _VP, _I, _VP],
    "brusselator_jvp_f64": [_VP, _VP, _VP, _VP, _I, _VP],
    "brusselator_jvp_bf16": [_VP, _VP, _VP, _VP, _I, _VP],
    "brusselator_jvp_bf16_f32t": [_VP, _VP, _VP, _VP, _I, _VP],
    "brusselator_jvp_scaled_f32": [_VP] * 4 + [_D] + [_VP] * 2 + [_I, _VP],
    "brusselator_jvp_scaled_f64": [_VP] * 4 + [_D] + [_VP] * 2 + [_I, _VP],
    "brusselator_jvp_scaled_pair_f32":
        [_VP] * 6 + [_D] + [_VP] * 3 + [_I, _VP],
    "brusselator_jvp_scaled_pair_f64":
        [_VP] * 6 + [_D] + [_VP] * 3 + [_I, _VP],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    return _backend.load("stencil", _SIGNATURES)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference the kernels are
# held against on the card)
# ---------------------------------------------------------------------------

def _periodic_lap(w):
    roll = _backend.roll            # torch.roll; a DTensor's as two slices
    return (roll(w, 1, 0) + roll(w, -1, 0)
            + roll(w, 1, 1) + roll(w, -1, 1) - 4.0 * w)


def _scalars(p, dtype):
    """(α/h², A+1, A) formed in p's dtype, then cast to the state's."""
    A, alpha, dx = p[0], p[2], p[3]
    return ((alpha / dx ** 2).to(dtype), (A + 1.0).to(dtype), A.to(dtype))


def _jvp_planes(u, v, tu, tv, al, ap1, A):
    two_uv = 2.0 * u * v
    u2 = u * u
    ou = al * _periodic_lap(tu) + (two_uv - ap1) * tu + u2 * tv
    ov = al * _periodic_lap(tv) + (A - two_uv) * tu - u2 * tv
    return ou, ov


def brusselator_jvp_plain(U, T, p):
    al, ap1, A = _scalars(p, U.dtype)
    ou, ov = _jvp_planes(U[..., 0], U[..., 1], T[..., 0], T[..., 1],
                         al, ap1, A)
    return torch.stack([ou, ov], dim=-1)


def _scalars_bf16(p):
    """K3's scalars: (α/h², A+1, A) formed in f32 from ``p`` (α/(dx·dx),
    as XLA evaluates ``dx ** 2``), then rounded to bf16."""
    A, alpha, dx = p[0], p[2], p[3]
    bf = torch.bfloat16
    return ((alpha / (dx * dx)).to(bf), (A + 1.0).to(bf), A.to(bf))


def brusselator_jvp_bf16_plain(U, T, p):
    """K3's plain version: ``_jvp_planes`` on bf16 tensors, every eager op
    rounded to bf16; ``p`` in f32."""
    al, ap1, A = _scalars_bf16(p)
    ou, ov = _jvp_planes(U[..., 0], U[..., 1], T[..., 0], T[..., 1],
                         al, ap1, A)
    return torch.stack([ou, ov], dim=-1)


def brusselator_jvp_bf16_f32_plain(U, T, p):
    """The f32-tangent variant's plain version: ``T`` (f32) cast to bf16,
    K3's plain version, the result cast back to f32."""
    return brusselator_jvp_bf16_plain(U, T.to(torch.bfloat16), p).float()


def brusselator_jvp_scaled_pair_plain(u, v, tu, tv, p, inv_scale):
    al, ap1, A = _scalars(p, u.dtype)
    inv = (inv_scale.to(u.dtype) if isinstance(inv_scale, torch.Tensor)
           else float(inv_scale))
    ou, ov = _jvp_planes(u, v, tu * inv, tv * inv, al, ap1, A)
    mx = torch.maximum(torch.max(torch.abs(ou)), torch.max(torch.abs(ov)))
    return ou, ov, mx


def brusselator_jvp_scaled_plain(U, T, p, inv_scale):
    ou, ov, mx = brusselator_jvp_scaled_pair_plain(
        U[..., 0], U[..., 1], T[..., 0], T[..., 1], p, inv_scale)
    return torch.stack([ou, ov], dim=-1), mx


# ---------------------------------------------------------------------------
# checks shared by the wrappers
# ---------------------------------------------------------------------------

def _check_state(name, x, shape, dtype, device, paired=True):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.data_ptr() % ((2 if paired else 1) * x.element_size()):
        raise ValueError(f"{name} is not aligned for the kernel's loads")


def _check_p(p, dtype, device):
    if not isinstance(p, torch.Tensor) or p.dim() != 1 or p.numel() < 4:
        raise ValueError("p must be a 1-d tensor (A, B, alpha, dx)")
    if p.device != device or p.dtype != dtype:
        raise TypeError(f"p must be {dtype} on {device} (the kernel forms "
                        f"its scalars in the state's dtype); got {p.dtype} "
                        f"on {p.device}")
    if not p.is_contiguous():
        raise ValueError("p must be contiguous")


def _grid_n(name, x, ndim):
    if x.dim() != ndim or x.shape[0] != x.shape[1] or x.shape[0] < 1:
        raise ValueError(f"{name} must be (N, N{', 2' if ndim == 3 else ''})"
                         f", got {tuple(x.shape)}")
    if ndim == 3 and x.shape[2] != 2:
        raise ValueError(f"{name} must be (N, N, 2), got {tuple(x.shape)}")
    return int(x.shape[0])


def _dtype_of(x):
    if x.dtype not in _SUFFIX:
        raise TypeError(f"kernel takes float32 or float64, got {x.dtype}")
    return x.dtype


def _inv_scale_tensor(inv_scale, dtype, device):
    """inv_scale as a 0-d tensor in ``dtype`` on ``device``."""
    if isinstance(inv_scale, torch.Tensor):
        if inv_scale.numel() != 1 or inv_scale.device != device:
            raise ValueError("inv_scale must be a scalar on the state's "
                             "device")
        return inv_scale.reshape(()).to(dtype).contiguous()
    return torch.full((), float(inv_scale), dtype=dtype, device=device)


def _inv_scale_args(inv_scale, dtype, device):
    """K2's inv_scale as the kernel takes it: a 0-d tensor by pointer (kept
    alive by the caller until the launch), a Python number by value.
    Returns ``(tensor or None, pointer, value)``."""
    if isinstance(inv_scale, torch.Tensor):
        inv = _inv_scale_tensor(inv_scale, dtype, device)
        return inv, _backend.ptr(inv), 0.0
    return None, ctypes.c_void_p(None), float(inv_scale)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------

def brusselator_jvp(U, T, p):
    """Fused JVP of ``models.brusselator.brusselator_2d`` at ``U`` applied to
    the tangent ``T``; both (N, N, 2) interleaved (u, v) pairs."""
    _backend.refuse_grad("K1 brusselator_jvp", U, T, p)
    if U.device.type == "cpu":
        return brusselator_jvp_plain(U, T, p)
    N = _grid_n("U", U, 3)
    dtype = _dtype_of(U)
    _check_state("U", U, (N, N, 2), dtype, U.device)
    _check_state("T", T, (N, N, 2), dtype, U.device)
    _check_p(p, dtype, U.device)
    out = torch.empty_like(U)
    lib = _lib()
    rc = getattr(lib, f"brusselator_jvp_{_SUFFIX[dtype]}")(
        _backend.ptr(U), _backend.ptr(T), _backend.ptr(p), _backend.ptr(out),
        N, _backend.stream_handle(U))
    _backend.check_launch(lib, rc, "brusselator_jvp")
    _backend.count_launch("brusselator_jvp")
    return out


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------

def brusselator_jvp_bf16(U, T, p):
    """K1 at bf16: ``U`` and ``T`` (N, N, 2) bf16, ``p`` (A, B, alpha, dx)
    f32; the result is (N, N, 2) bf16."""
    _backend.refuse_grad("K3 brusselator_jvp_bf16", U, T, p)
    if U.device.type == "cpu":
        return brusselator_jvp_bf16_plain(U, T, p)
    N = _grid_n("U", U, 3)
    bf = torch.bfloat16
    _check_state("U", U, (N, N, 2), bf, U.device)
    _check_state("T", T, (N, N, 2), bf, U.device)
    _check_p(p, torch.float32, U.device)
    out = torch.empty_like(U)
    lib = _lib()
    rc = lib.brusselator_jvp_bf16(
        _backend.ptr(U), _backend.ptr(T), _backend.ptr(p), _backend.ptr(out),
        N, _backend.stream_handle(U))
    _backend.check_launch(lib, rc, "brusselator_jvp_bf16")
    _backend.count_launch("brusselator_jvp_bf16")
    return out


def brusselator_jvp_bf16_f32(U, T, p):
    """K3 on an f32 tangent in one launch: ``U`` (N, N, 2) bf16, ``T``
    (N, N, 2) f32, rounded to bf16 on read (nearest even, as
    ``.to(torch.bfloat16)``), ``p`` f32; the bf16 result comes back widened
    to f32.  Bit for bit ``brusselator_jvp_bf16(U, T.to(bf16), p).float()``.
    Counted as a ``brusselator_jvp_bf16`` launch."""
    _backend.refuse_grad("K3 brusselator_jvp_bf16", U, T, p)
    if U.device.type == "cpu":
        return brusselator_jvp_bf16_f32_plain(U, T, p)
    N = _grid_n("U", U, 3)
    _check_state("U", U, (N, N, 2), torch.bfloat16, U.device)
    _check_state("T", T, (N, N, 2), torch.float32, U.device)
    _check_p(p, torch.float32, U.device)
    out = torch.empty_like(T)
    lib = _lib()
    rc = lib.brusselator_jvp_bf16_f32t(
        _backend.ptr(U), _backend.ptr(T), _backend.ptr(p), _backend.ptr(out),
        N, _backend.stream_handle(U))
    _backend.check_launch(lib, rc, "brusselator_jvp_bf16_f32")
    _backend.count_launch("brusselator_jvp_bf16")
    return out


def make_brusselator_jvp_bf16(U, p):
    """Mixed-precision matvec factory (``ops/pallas_stencil.py``'s): returns
    ``mv(T) -> J·T`` with the state cast to bf16 once, here, and ``p`` to
    f32.  ``mv`` computes in bf16 and returns ``T``'s dtype, so a Krylov
    basis around it keeps its own: an f32 tangent takes K3's f32 variant
    (one launch), a bf16 tangent K3 itself, any other dtype the cast to
    bf16, K3 and the cast back."""
    Ub = U.to(torch.bfloat16).contiguous()
    p32 = p.to(torch.float32).contiguous()

    def mv(T):
        if T.dtype == torch.float32:
            return brusselator_jvp_bf16_f32(Ub, T.contiguous(), p32)
        if T.dtype == torch.bfloat16:
            return brusselator_jvp_bf16(Ub, T.contiguous(), p32)
        out = brusselator_jvp_bf16(Ub, T.to(torch.bfloat16).contiguous(), p32)
        return out.to(T.dtype)

    return mv


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------

def brusselator_jvp_scaled(U, T, p, inv_scale):
    """``(J · (T · inv_scale), max|out|)`` in one pass, on (N, N, 2) state
    and tangent.  The max is a 0-d tensor left on the device."""
    _backend.refuse_grad("K2 brusselator_jvp_scaled", U, T, p, inv_scale)
    if U.device.type == "cpu":
        return brusselator_jvp_scaled_plain(U, T, p, inv_scale)
    N = _grid_n("U", U, 3)
    dtype = _dtype_of(U)
    _check_state("U", U, (N, N, 2), dtype, U.device)
    _check_state("T", T, (N, N, 2), dtype, U.device)
    _check_p(p, dtype, U.device)
    inv, inv_ptr, inv_val = _inv_scale_args(inv_scale, dtype, U.device)
    out = torch.empty_like(U)
    mx = torch.empty((), dtype=dtype, device=U.device)
    lib = _lib()
    rc = getattr(lib, f"brusselator_jvp_scaled_{_SUFFIX[dtype]}")(
        _backend.ptr(U), _backend.ptr(T), _backend.ptr(p), inv_ptr, inv_val,
        _backend.ptr(out), _backend.ptr(mx), N, _backend.stream_handle(U))
    _backend.check_launch(lib, rc, "brusselator_jvp_scaled")
    _backend.count_launch("brusselator_jvp_scaled")
    return out, mx


def brusselator_jvp_scaled_pair(u, v, tu, tv, p, inv_scale):
    """``brusselator_jvp_scaled`` on component planes (four (N, N) tensors);
    returns ``(ou, ov, absmax)``."""
    _backend.refuse_grad("K2 brusselator_jvp_scaled", u, v, tu, tv, p,
                        inv_scale)
    if u.device.type == "cpu":
        return brusselator_jvp_scaled_pair_plain(u, v, tu, tv, p, inv_scale)
    N = _grid_n("u", u, 2)
    dtype = _dtype_of(u)
    for name, x in (("u", u), ("v", v), ("tu", tu), ("tv", tv)):
        _check_state(name, x, (N, N), dtype, u.device, paired=False)
    _check_p(p, dtype, u.device)
    inv, inv_ptr, inv_val = _inv_scale_args(inv_scale, dtype, u.device)
    ou = torch.empty_like(u)
    ov = torch.empty_like(u)
    mx = torch.empty((), dtype=dtype, device=u.device)
    lib = _lib()
    rc = getattr(lib, f"brusselator_jvp_scaled_pair_{_SUFFIX[dtype]}")(
        _backend.ptr(u), _backend.ptr(v), _backend.ptr(tu), _backend.ptr(tv),
        _backend.ptr(p), inv_ptr, inv_val, _backend.ptr(ou),
        _backend.ptr(ov), _backend.ptr(mx), N, _backend.stream_handle(u))
    _backend.check_launch(lib, rc, "brusselator_jvp_scaled_pair")
    _backend.count_launch("brusselator_jvp_scaled")
    return ou, ov, mx

"""The 3D reaction–diffusion stencil JVP (the port of
``ops/pallas_stencil3d.py``).

K9 ``rd3d_jvp_blocked(u, t, D, bz=, double_buffer=)`` replaces
``_rd3d_jvp_kernel`` / ``_rd3d_jvp_kernel_db`` (the Jv of every GMRES
iteration of the 3D solve); K10 ``rd3d_jvp_scaled(u, t, D, inv_scale, bz=)``
replaces ``_rd3d_jvp_kernel_db_scaled`` (the chained, normalised matvec);
K11 ``rd3d_jvp_blocked_halo(u, t, lo, hi, D, bz=, n_global=)`` replaces
``_rd3d_jvp_kernel_halo`` (the per-shard operator of the z-sharded grid,
``parallel/distributed.py``): K9 on a z-shard whose neighbour planes ``lo``
and ``hi`` (each (1, ny, nx)) were received from the neighbouring ranks,
with h = 1/n_global.  All are CUDA C++ for ``sm_90a`` in
``csrc/stencil3d.cu``; that file's header says what bounds them on the H100
(bytes: at f32 256³ about 201 MB of HBM traffic per call) and what its
design does about it (a block a (y, x) tile marching z, a ``cp.async``
ring of planes in shared memory, 16-byte loads and stores).

On an (nz, ny, nx) grid, periodic on every axis, with h = 1/nz:
``out = (D/h²)·Δt + (1 − 3u²)·t``.  ``D/h²`` is formed in the state's dtype,
as the JAX wrappers form it.  ``bz`` must divide nz, as in the JAX package;
it is the number of z-planes one block (and each of its threads) of the
kernel marches over; the result does not depend on it.
``double_buffer`` is accepted and gives the same result: its DMA pipelining
is the TPU's and has no counterpart here.

Each wrapper takes its plain PyTorch version (``*_plain``, written with
``torch.roll``) for a tensor on the CPU, and only there.  For a CUDA tensor
it checks device, dtype, shape and contiguity, launches the kernel on the
current stream and counts the launch in ``_backend.LAUNCHES``
(``rd3d_jvp``, ``rd3d_jvp_scaled``, ``rd3d_jvp_halo``); anything the
kernel does not take raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _backend
from .stencil import _check_state, _dtype_of, _inv_scale_tensor

_VP = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "rd3d_jvp_f32": [_VP] * 5 + [_D, _VP, _I, _I, _I, _I, _VP],
    "rd3d_jvp_f64": [_VP] * 5 + [_D, _VP, _I, _I, _I, _I, _VP],
    "rd3d_jvp_scaled_f32": [_VP] * 5 + [_D] + [_VP] * 3 + [_I] * 4 + [_VP],
    "rd3d_jvp_scaled_f64": [_VP] * 5 + [_D] + [_VP] * 3 + [_I] * 4 + [_VP],
}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    return _backend.load("stencil3d", _SIGNATURES)


def _check_bz(t, bz: int, what: str = "Nz") -> int:
    """nz of the (nz, ny, nx) tangent; raises the JAX package's ValueError
    when ``bz`` does not divide it (``what`` names nz as that message
    does)."""
    if t.dim() != 3:
        raise ValueError(f"the state must be (nz, ny, nx), got "
                         f"{tuple(t.shape)}")
    nz = int(t.shape[0])
    if bz < 1 or nz % bz:
        raise ValueError(f"bz={bz} must divide {what}={nz}")
    return nz


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the reference the kernels are
# held against on the card)
# ---------------------------------------------------------------------------

def _d_h2(D, nz: int, dtype) -> torch.Tensor:
    """D/h² with h = 1/nz, in ``dtype``: a tensor D divides in its dtype
    cast to the state's, a Python D divides in double and is then cast."""
    h2 = (1.0 / nz) ** 2
    if isinstance(D, torch.Tensor):
        return D.to(dtype) / h2
    return torch.tensor(D / h2, dtype=dtype)


def _stencil(u, t, up, down, d_h2):
    """``_rd3d_stencil``: the z-neighbours ``up`` (t[z−1]) and ``down``
    (t[z+1]) given, the in-plane ones by rolls, in the JAX kernel's order."""
    inplane = (torch.roll(t, 1, 1) + torch.roll(t, -1, 1)
               + torch.roll(t, 1, 2) + torch.roll(t, -1, 2) - 6.0 * t)
    return d_h2 * (inplane + up + down) + (1.0 - 3.0 * u * u) * t


def rd3d_jvp_blocked_plain(u, t, D):
    d_h2 = _d_h2(D, int(t.shape[0]), u.dtype)
    return _stencil(u, t, torch.roll(t, 1, 0), torch.roll(t, -1, 0), d_h2)


def rd3d_jvp_blocked_halo_plain(u, t, lo, hi, D, n_global=None):
    """K11's plain version: the shard's z-neighbours from ``lo`` (before
    its first plane) and ``hi`` (after its last), h = 1/n_global."""
    nz = int(t.shape[0])
    d_h2 = _d_h2(D, nz if n_global is None else n_global, u.dtype)
    return _stencil(u, t, torch.cat([lo, t[:-1]]), torch.cat([t[1:], hi]),
                    d_h2)


def rd3d_jvp_scaled_plain(u, t, D, inv_scale):
    inv = (inv_scale.to(u.dtype) if isinstance(inv_scale, torch.Tensor)
           else float(inv_scale))
    out = rd3d_jvp_blocked_plain(u, t, D) * inv
    return out, torch.max(torch.abs(out))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _scalar_args(u, t, D, n_h=None):
    """(dtype, (nz, ny, nx), D pointer tensor, h2) for a CUDA launch, with
    h = 1/n_h (1/nz when ``n_h`` is None)."""
    dtype = _dtype_of(u)
    shape = tuple(int(s) for s in t.shape)
    _check_state("u", u, shape, dtype, u.device, paired=False)
    _check_state("t", t, shape, dtype, u.device, paired=False)
    h2 = (1.0 / (shape[0] if n_h is None else n_h)) ** 2
    if isinstance(D, torch.Tensor):
        if D.numel() != 1 or D.device != u.device:
            raise ValueError("D must be a scalar on the state's device")
        return dtype, shape, D.reshape(()).to(dtype).contiguous(), h2
    return dtype, shape, torch.full((), D / h2, dtype=dtype,
                                    device=u.device), 1.0


def _halo_planes(t, shape):
    """The periodic halo: the plane before z = 0 is t's last, the plane
    after z = nz-1 is t's first."""
    return t[shape[0] - 1], t[0]


def _launch_jvp(counter, u, t, lo, hi, d, h2, dtype, shape, bz):
    """K9's kernel with the halo planes ``lo``/``hi``, counted as
    ``counter`` (K9 passes t's wrapped planes, K11 the received ones)."""
    out = torch.empty_like(u)
    lib = _lib()
    rc = getattr(lib, f"rd3d_jvp_{_SUFFIX[dtype]}")(
        _backend.ptr(u), _backend.ptr(t), _backend.ptr(lo), _backend.ptr(hi),
        _backend.ptr(d), h2, _backend.ptr(out), shape[0], shape[1], shape[2],
        bz, _backend.stream_handle(u))
    _backend.check_launch(lib, rc, counter)
    _backend.count_launch(counter)
    return out


def rd3d_jvp_blocked(u, t, D, *, bz: int = 8, double_buffer: bool = False):
    """JVP of ``D Δu + u − u³ + g`` at ``u`` applied to ``t``:
    ``D Δt + (1 − 3u²) t`` on a periodic (nz, ny, nx) grid, h = 1/nz."""
    _backend.refuse_grad("K9 rd3d_jvp_blocked", u, t, D)
    _check_bz(t, bz)
    if u.device.type == "cpu":
        return rd3d_jvp_blocked_plain(u, t, D)
    dtype, shape, d, h2 = _scalar_args(u, t, D)
    lo, hi = _halo_planes(t, shape)
    return _launch_jvp("rd3d_jvp", u, t, lo, hi, d, h2, dtype, shape, bz)


def rd3d_jvp_blocked_halo(u, t, lo, hi, D, *, bz: int = 8,
                          n_global=None):
    """K11: ``rd3d_jvp_blocked`` on a z-shard (nz, ny, nx) whose plane
    before z = 0 is ``lo`` and after z = nz-1 is ``hi`` (each (1, ny, nx),
    received from the neighbouring shards), with h = 1/n_global (1/nz when
    None).  ``bz`` must divide the local nz."""
    _backend.refuse_grad("K11 rd3d_jvp_blocked_halo", u, t, lo, hi, D)
    _check_bz(t, bz, "local Nz")
    if u.device.type == "cpu":
        return rd3d_jvp_blocked_halo_plain(u, t, lo, hi, D, n_global)
    dtype, shape, d, h2 = _scalar_args(u, t, D, n_global)
    for name, x in (("lo", lo), ("hi", hi)):
        _check_state(name, x, (1,) + shape[1:], dtype, u.device,
                     paired=False)
    return _launch_jvp("rd3d_jvp_halo", u, t, lo, hi, d, h2, dtype, shape,
                       bz)


def rd3d_jvp_scaled(u, t, D, inv_scale, *, bz: int = 4):
    """``((J·t)·inv_scale, max|out|)`` in one pass; the max is a 0-d tensor
    of the state's dtype, left on the device."""
    _backend.refuse_grad("K10 rd3d_jvp_scaled", u, t, D, inv_scale)
    nz = _check_bz(t, bz)
    if u.device.type == "cpu":
        return rd3d_jvp_scaled_plain(u, t, D, inv_scale)
    dtype, shape, d, h2 = _scalar_args(u, t, D)
    inv = _inv_scale_tensor(inv_scale, dtype, u.device)
    lo, hi = _halo_planes(t, shape)
    out = torch.empty_like(u)
    mx = torch.zeros((), dtype=dtype, device=u.device)
    lib = _lib()
    rc = getattr(lib, f"rd3d_jvp_scaled_{_SUFFIX[dtype]}")(
        _backend.ptr(u), _backend.ptr(t), _backend.ptr(lo), _backend.ptr(hi),
        _backend.ptr(d), h2, _backend.ptr(inv), _backend.ptr(out),
        _backend.ptr(mx), nz, shape[1], shape[2], bz,
        _backend.stream_handle(u))
    _backend.check_launch(lib, rc, "rd3d_jvp_scaled")
    _backend.count_launch("rd3d_jvp_scaled")
    return out, mx

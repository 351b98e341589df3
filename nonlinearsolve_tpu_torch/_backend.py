"""Device and dtype policy, the CUDA kernel build, and the port's counters.

Device policy: every entry point runs on the card unless the caller asks for
the CPU.  ``resolve_device(None)`` is ``cuda``; with no CUDA it raises — it
never falls back to the CPU.  The CPU runs only when asked for
(``device="cpu"``), and there each kernel wrapper takes its plain PyTorch
version.

Kernel build: the CUDA sources under ``csrc/`` are compiled at first use by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
(loaded with ``ctypes``), in ``csrc/build/``.  The host toolkit
(``native.py``: the repo's ``csrc/sparsetools.cpp``) goes through the same
``compile_shared`` with ``g++``.  A library's name carries a hash of the
source and the command, so an edited source is rebuilt and a stale library
is never loaded.  A build failure raises with the compiler's output;
nothing falls back.

Grad: ``refuse_grad`` is every kernel wrapper's first line: a wrapper
whose inputs require grad under grad mode, or carry a forward-mode
tangent, raises rather than return a result detached from the
derivative (the reverse rules live in ``ops/spmv.py`` ``SpmvFunction``
and ``DiaFunction``).

Counters: ``LAUNCHES`` counts kernel launches per kernel (each wrapper adds
one where it launches its kernel, and nowhere else); ``HOST_SYNCS`` counts
device-to-host reads made by ``fetch`` — the points where the host waits for
the device; ``ROUTES`` counts the linear solves of the sparse direct route by
route (``ops/direct_sparse.py``) and the device LU's solves
(``ops/device_lu.py``).  ``reset_counters`` zeroes all three.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch
from torch.autograd import forward_ad

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES: dict = {"brusselator_jvp": 0, "brusselator_jvp_scaled": 0,
                  "brusselator_jvp_bf16": 0,
                  "dia_spmv": 0, "gather_spmv": 0, "gather_select": 0,
                  "band_spmv": 0, "scatter_spmv_part": 0,
                  "bsr_spmm": 0,
                  "rd3d_jvp": 0, "rd3d_jvp_scaled": 0, "rd3d_jvp_halo": 0}
HOST_SYNCS: dict = {"n": 0}
ROUTES: dict = {"pcr": 0, "bcr": 0, "rcm_bcr": 0, "host_lu": 0,
                "iterative": 0, "dense": 0, "device_lu": 0}


#: collectives issued by the distributed layer's explicit tier (P2P sends
#: of the ring halos and all_gathers of x), counted where they are issued
COLLECTIVES: dict = {"p2p_send": 0, "all_gather": 0}


def reset_counters() -> None:
    for counts in (LAUNCHES, ROUTES, COLLECTIVES):
        for k in counts:
            counts[k] = 0
    HOST_SYNCS["n"] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def count_collective(name: str) -> None:
    COLLECTIVES[name] += 1


def count_route(name: str) -> None:
    ROUTES[name] += 1


def refuse_grad(kernel: str, *inputs, via: str = None) -> None:
    """Raise, on every device, when an input is to be differentiated: a
    kernel wrapper never returns a result detached from the derivative it
    was asked to carry.

    - Reverse mode (grad mode on and an input requires grad): without
      ``via`` the kernel has no reverse rule, as the JAX package's Pallas
      kernel has none (``jax.grad`` through it raises); with it, the rule
      lives in the differentiable entry ``via`` names, and the bare wrapper
      is forward-only.
    - Forward mode (an input carries a ``torch.autograd.forward_ad``
      tangent, as inside ``torch.func.jvp``): no kernel has a tangent
      rule, as the JAX package's custom VJPs refuse ``jax.jvp``."""
    if forward_ad._current_level >= 0 and any(
            isinstance(t, torch.Tensor)
            and forward_ad.unpack_dual(t).tangent is not None
            for t in inputs):
        raise NotImplementedError(
            f"{kernel} has no forward-mode rule: a tangent "
            f"(torch.autograd.forward_ad, torch.func.jvp) through it is "
            f"not supported")
    if not torch.is_grad_enabled() or not any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in inputs):
        return
    if via is None:
        raise NotImplementedError(
            f"{kernel} has no reverse rule: reverse-mode differentiation "
            f"through it is not supported (jax.grad through the JAX "
            f"package's kernel raises as well)")
    raise NotImplementedError(
        f"the {kernel} wrapper is forward-only: differentiate through "
        f"{via}, which carries the kernel's reverse rule")


# ---------------------------------------------------------------------------
# device / dtype
# ---------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """``None`` → the card.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nonlinearsolve_tpu_torch runs on the CUDA device by default, "
            "and torch.cuda.is_available() is False; pass device='cpu' to "
            "run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "complex64": torch.complex64, "complex128": torch.complex128}


def resolve_dtype(dtype) -> torch.dtype:
    """Accept a torch dtype, a numpy dtype or a name: f32, f64 and their
    complex counterparts (complex states, as the JAX package takes
    them)."""
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = _DTYPES.get(np.dtype(dtype).name)
    if out not in _DTYPES.values():
        raise TypeError(f"unsupported dtype {dtype!r}: float32, float64, "
                        f"complex64 or complex128")
    return out


_NP_OF = {torch.float32: np.float32, torch.float64: np.float64,
          torch.complex64: np.complex64, torch.complex128: np.complex128,
          torch.bool: np.bool_}


def np_dtype(dtype):
    """The numpy scalar type of a torch dtype (f32, f64, complex64,
    complex128 or bool): host arithmetic in it rounds as the device's
    does."""
    dtype = resolve_dtype(dtype) if not isinstance(dtype, torch.dtype) \
        else dtype
    if dtype not in _NP_OF:
        raise TypeError(f"unsupported dtype {dtype}: float32, float64, "
                        f"complex64 or complex128")
    return _NP_OF[dtype]


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """The real dtype of a complex one (norms and tolerances are real)."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def real_np_dtype(dtype: torch.dtype):
    """``np_dtype`` of the real dtype: host norms, objectives and
    tolerances of a complex state are real."""
    return np_dtype(real_dtype(dtype))


_HOST_OF = {**_NP_OF, torch.int32: np.int32}


def fetch(*tensors: torch.Tensor) -> list:
    """Read small tensors (f32, f64, complex64, complex128, bool or int32)
    to the host in ONE transfer — one host sync.  Each comes back in its
    own dtype, so that host arithmetic on it rounds as the device's would:
    a 0-d tensor as a numpy scalar, any other as a 1-d numpy array.
    (Mixed dtypes travel as f64, which holds every f32, int32 and bool
    value exactly, or as complex128 when one of them is complex.)"""
    HOST_SYNCS["n"] += 1
    tensors = [whole(t) for t in tensors]
    wire = tensors[0].dtype
    if any(t.dtype != wire for t in tensors):
        wire = (torch.complex128 if any(t.is_complex() for t in tensors)
                else torch.float64)
    host = torch.cat([t.reshape(-1).to(wire) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        part = host[at:at + t.numel()]
        if part.dtype.kind == "c" and not t.is_complex():
            part = part.real
        part = part.astype(_HOST_OF[t.dtype])
        out.append(part[0] if t.dim() == 0 else part)
        at += t.numel()
    return out


def whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value as a plain tensor on this rank (a
    replicated scalar's own copy; a sharded one gathered); any other
    tensor as it is."""
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def apply_whole(fn, v: torch.Tensor) -> torch.Tensor:
    """``fn`` of a DTensor ``v`` gathered whole on every rank, the result
    sharded as ``v`` is (each rank keeps its shard, no communication): the
    preconditioners whose DTensor ops would take collectives in every
    pass (the FFT's transforms, the V-cycle's rolls and restrictions)."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(fn(v.full_tensor()), v.device_mesh,
                             v.placements, src_data_rank=None)


def roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll``; a DTensor is rolled as the concatenation of its two
    slices, the same values.  torch 2.11's DTensor has no sharding rule for
    ``roll``, and slices and ``cat`` keep their rules under the
    reverse-over-reverse J·v of a sharded state (``core/autodiff.py``)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return torch.roll(x, shift, dim)
    n = x.shape[dim]
    s = shift % n
    if s == 0:
        return x
    return torch.cat([x.narrow(dim, n - s, s), x.narrow(dim, 0, n - s)], dim)


def to_host(t: torch.Tensor) -> np.ndarray:
    """Copy a tensor of any size to the host as a numpy array: one host
    sync, counted as ``fetch`` counts its reads (the host calls of the
    sparse direct route: the native LU and the device LU's refresh)."""
    HOST_SYNCS["n"] += 1
    return t.detach().cpu().numpy()


class PendingReads:
    """Device scalars waiting for a host read.  ``defer`` queues one under a
    key; the next ``read`` — whoever makes it — takes the queued scalars
    along in the same ``fetch`` and keeps their host values in ``values``.
    So a step's own flags ride on the first read its line search makes."""

    def __init__(self):
        self._queue: list = []
        self.values: dict = {}

    def defer(self, key, t: torch.Tensor) -> None:
        self._queue.append((key, t))

    def read(self, *tensors: torch.Tensor) -> list:
        """The host values of ``tensors`` (as ``fetch`` gives them), in one
        host sync with the queued scalars."""
        queued = self._queue
        if not queued and not tensors:
            return []
        self._queue = []
        host = fetch(*[t for _, t in queued], *tensors)
        self.values.update((k, v) for (k, _), v in zip(queued, host))
        return host[len(queued):]


# ---------------------------------------------------------------------------
# kernel build and load
# ---------------------------------------------------------------------------

_LIBS: dict = {}
_BUILD_LOCK = threading.Lock()
BUILD_LOGS: dict = {}


def _find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): "
                       "the CUDA kernels cannot be built")


def _shared_path(src: Path, stem: str, cmd_prefix) -> Path:
    digest = hashlib.sha256(Path(src).read_bytes()
                            + " ".join(cmd_prefix).encode()).hexdigest()
    return BUILD_DIR / f"lib{stem}_{digest[:16]}.so"


def compile_shared(src: Path, stem: str, label: str, tool: str,
                   flags) -> Path:
    """Compile ``src`` with ``[tool, *flags, "-o", out, src]`` into
    ``BUILD_DIR/lib<stem>_<hash>.so`` unless that library exists; the hash
    covers the source and the flags.  Raises with the compiler's output
    (``label`` names the compiler) when the build fails."""
    so = _shared_path(src, stem, flags)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([tool, *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    BUILD_LOGS[stem] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{label} failed for {src} "
                           f"(rc {proc.returncode}):\n{BUILD_LOGS[stem]}")
    os.replace(tmp, so)
    return so


def library_path(name: str) -> Path:
    return _shared_path(CSRC / f"{name}.cu", name, NVCC_FLAGS)


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` with nvcc unless its library exists."""
    return compile_shared(CSRC / f"{name}.cu", name, "nvcc", _find_nvcc(),
                          NVCC_FLAGS)


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C entry point to its ``argtypes`` (every entry point returns the
    ``cudaError_t`` of its launch as an int)."""
    with _BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.nls_error_string.argtypes = [ctypes.c_int]
            lib.nls_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.nls_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def stream_handle(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())

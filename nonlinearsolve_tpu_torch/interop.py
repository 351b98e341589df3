"""Carry a run's state across from the JAX package, through numpy.

This system has no weights: what defines a run is the problem data — the
Brusselator's ``(u0, p)`` (the JAX package's ``models.brusselator.init_u0`` /
``default_p`` output), the 3D reaction–diffusion problem's ``(u0, D, g)``
(``models.reaction_diffusion.make_problem``'s ``u0`` and ``p``) — and the
preconditioner's ``(grid_shape, alpha, h, shift)``, which are plain numbers
and pass as they are.  ``problem_from_numpy`` and
``reaction_diffusion_problem_from_numpy`` build the port's problems from the
arrays; ``csr_from_numpy``, ``bsr_from_numpy`` and ``ell_from_numpy`` carry
a sparse matrix (a JAX ``CSR``'s, ``BSR``'s or ``ELL``'s arrays and shape);
``shard_from_numpy`` turns a
global array (a JAX global array, as numpy) into the port's z-sharded
DTensor on a mesh of ``parallel.mesh``; ``solution_to_numpy`` returns a
solution as numpy arrays and ints, for comparison with the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import _backend
from .core.problems import NonlinearProblem
from .core.solution import NonlinearSolution
from .models import brusselator, reaction_diffusion
from .ops.sparse import BSR, CSR, ELL


def problem_from_numpy(u0, p, *, kernel_jvp: bool = False, device=None,
                       dtype=None) -> NonlinearProblem:
    """The Brusselator steady-state problem at state ``u0`` (N, N, 2) and
    parameters ``p`` (A, B, alpha, dx), on ``device`` (the card by
    default), in ``dtype`` (``u0``'s by default)."""
    dev = _backend.resolve_device(device)
    u0 = np.asarray(u0)
    dt = _backend.resolve_dtype(u0.dtype if dtype is None else dtype)
    npdt = np.float32 if dt == torch.float32 else np.float64
    U = torch.as_tensor(u0.astype(npdt), device=dev)      # a copy
    P = torch.as_tensor(np.asarray(p).astype(npdt), device=dev)
    return brusselator.problem(U, P, kernel_jvp=kernel_jvp)


def reaction_diffusion_problem_from_numpy(u0, D, g, *,
                                          kernel_jvp: bool = False,
                                          device=None,
                                          dtype=None) -> NonlinearProblem:
    """The 3D reaction–diffusion problem at state ``u0`` (N, N, N) with
    diffusion ``D`` (a number or a 0-d array) and forcing ``g`` (N, N, N),
    on ``device`` (the card by default), in ``dtype`` (``u0``'s by
    default); ``kernel_jvp`` is ``make_problem``'s."""
    dev = _backend.resolve_device(device)
    u0 = np.asarray(u0)
    dt = _backend.resolve_dtype(u0.dtype if dtype is None else dtype)
    npdt = _backend.np_dtype(dt)
    p = tuple(torch.as_tensor(np.asarray(a).astype(npdt), device=dev)
              for a in (D, g))
    return reaction_diffusion.problem(
        torch.as_tensor(u0.astype(npdt), device=dev), p,
        kernel_jvp=kernel_jvp)


def csr_from_numpy(indptr, indices, data, shape, device=None) -> CSR:
    """The port's ``CSR`` of a matrix given by its CSR arrays (host
    pattern, ``data`` on ``device``, the card by default, in its own
    dtype)."""
    return CSR(_values(data, _backend.resolve_device(device)),
               np.asarray(indices), np.asarray(indptr), shape)


def _values(data, dev):
    data = np.asarray(data)
    dt = _backend.resolve_dtype(data.dtype)
    return torch.as_tensor(data.astype(_backend.np_dtype(dt)), device=dev)


def bsr_from_numpy(data, indices, indptr, shape, blocksize,
                   device=None) -> BSR:
    """The port's ``BSR`` of a JAX ``BSR``'s arrays: ``data`` (nblocks, b,
    b) on ``device`` (the card by default) in its own dtype, the block
    pattern on the host."""
    return BSR(_values(data, _backend.resolve_device(device)),
               np.asarray(indices), np.asarray(indptr), shape, blocksize)


def ell_from_numpy(data, cols, valid, shape, device=None) -> ELL:
    """The port's ``ELL`` of a JAX ``ELL``'s arrays: ``data`` (n_rows,
    width) on ``device`` (the card by default), ``cols`` and ``valid`` on
    the host."""
    return ELL(_values(data, _backend.resolve_device(device)),
               np.asarray(cols), np.asarray(valid), shape)


def shard_from_numpy(x, mesh):
    """The global array ``x`` (f32 or f64; every rank holds all of it, as a
    JAX global array read back with numpy) as a DTensor sharded on its
    leading axis over ``mesh``'s first axis: each member rank keeps its own
    block of rows, on the mesh's device.  The leading axis must divide
    evenly, as a shard_map in_spec needs."""
    from torch.distributed.tensor import DTensor

    from .parallel.mesh import mesh_device, row_sharding

    x = np.asarray(x)
    dt = _backend.resolve_dtype(x.dtype)
    n = mesh.size(0)
    if x.ndim < 1 or x.shape[0] % n:
        raise ValueError(f"the leading axis of an array of shape {x.shape} "
                         f"does not split evenly over {n} ranks")
    rows = x.shape[0] // n
    r = mesh.get_local_rank(0)
    local = np.ascontiguousarray(x[r * rows:(r + 1) * rows],
                                 dtype=_backend.np_dtype(dt))
    full = torch.empty(x.shape, dtype=dt, device="meta")
    return DTensor.from_local(
        torch.as_tensor(local, device=mesh_device(mesh)), mesh,
        row_sharding(mesh, mesh.mesh_dim_names[0], x.ndim), run_check=False,
        shape=full.shape, stride=full.stride())


def solution_to_numpy(sol: NonlinearSolution) -> dict:
    """``u``, ``resid`` (numpy), ``retcode`` (int) and ``stats`` (dict of
    ints)."""
    return {
        "u": sol.u.detach().cpu().numpy(),
        "resid": sol.resid.detach().cpu().numpy(),
        "retcode": int(sol.retcode),
        "stats": {k: int(v) for k, v in
                  dataclasses.asdict(sol.stats).items()},
    }

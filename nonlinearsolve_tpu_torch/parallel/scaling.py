"""Weak-scaling measurement (the port of ``parallel/scaling.py``).

The JAX package's ``weak_scaling_report`` measures the nnz/s of the 3D
reaction–diffusion Jacobian operator on a per-device slab of base_n ×
base_n² points, sharded over a growing mesh.  Here each size k takes the
first k ranks of the default process group: every rank calls the report,
the members run the chained matvec on their slab, and the slowest member's
time is the step's (a MAX all-reduce over the default group), so every rank
returns the same rows.  The chain runs on each member's own slab through
the factory's per-shard body (``PerShard.local``): the operator and its
halo exchange as the DTensor call runs them, without DTensor's dispatch
on the host in every step (a jitted JAX chain has none either).  The time
is ``perf_counter`` between two ``torch.cuda.synchronize()`` on the card,
``perf_counter`` alone on the CPU.
"""

from __future__ import annotations

import time
from typing import Sequence

import torch
import torch.distributed as dist

from .mesh import create_mesh, mesh_device


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def weak_scaling_report(device_counts: Sequence[int], base_n: int = 32,
                        n_matvecs: int = 50, dtype=torch.float32,
                        devices=None, use_pallas: bool = False, bz: int = 8):
    """A (base_n·k, base_n, base_n) state sharded on z over the first k of
    ``devices`` (ranks; all by default), u = 0.1, D = 0.01; the chain
    ``c ← lin(c)·1e-3`` of ``n_matvecs`` products, run once to warm up and
    once timed, as the JAX package runs it.  Returns
    ``[(k, nnz_per_s, efficiency_vs_1)]`` with 7 nnz a point.

    ``use_pallas`` takes the per-shard kernel tier
    (``sharded_rd3d_jvp_pallas_factory``: K11 on each shard, bz halved
    until it divides base_n); otherwise the roll tier
    (``sharded_rd3d_jvp_factory``), which computes the same J·t as the JAX
    package's GSPMD ``jax.linearize`` tier (torch has no GSPMD)."""
    from .distributed import (sharded_rd3d_jvp_factory,
                              sharded_rd3d_jvp_pallas_factory)

    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    me = dist.get_rank()
    results = []
    base_rate = None
    for k in device_counts:
        if k > len(ranks):
            break
        mesh = create_mesh((k,), ("x",), devices=ranks[:k])
        device = mesh_device(mesh)
        N0 = base_n * k
        dt = 0.0
        if me in ranks[:k]:
            u = torch.full((base_n, base_n, base_n), 0.1, dtype=dtype,
                           device=device)
            if use_pallas:
                bz_k = bz
                while base_n % bz_k:
                    bz_k //= 2
                jvp = sharded_rd3d_jvp_pallas_factory(mesh, 0.01, N0,
                                                      bz=max(bz_k, 1))
            else:
                jvp = sharded_rd3d_jvp_factory(mesh, 0.01, N0)

            def chain(v):
                for _ in range(n_matvecs):
                    v = jvp.local(u, v) * 1e-3
                return v

            v0 = torch.ones_like(u)
            chain(v0)
            _sync(device)
            t0 = time.perf_counter()
            chain(v0)
            _sync(device)
            dt = time.perf_counter() - t0
        slowest = torch.tensor(dt, dtype=torch.float64, device=device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        dt = float(slowest)
        nnz = 7 * N0 * base_n * base_n      # 7-point stencil
        rate = n_matvecs * nnz / dt
        if base_rate is None:
            base_rate = rate / k
        results.append((k, rate, rate / (base_rate * k)))
    return results


def weak_scaling_sparse_report(device_counts: Sequence[int],
                               rows_per_device: int = 4096,
                               n_matvecs: int = 50, dtype=torch.float32,
                               devices=None):
    """Weak scaling of the row-partitioned general-sparse operator
    (``parallel/sparse_dist.py``): each of the first k of ``devices``
    (ranks; all by default) owns ``rows_per_device`` rows of the JAX
    package's banded-plus-noise CSR (diagonals 0, ±1, ±⌊√n⌋, values
    perturbed by ``default_rng(0)``, one generator for the whole report),
    whose halo rides the ring.  The chain ``c ← A·c / max(‖A·c‖∞, 1)`` of
    ``n_matvecs`` products runs once to warm up and once timed, on each
    member's own chunk (``matvec.local``; the ∞-norm all-reduced).
    Returns ``[(k, nnz_per_s, efficiency_vs_1)]``, the rows of
    ``weak_scaling_report``."""
    import numpy as np
    import scipy.sparse as sp

    from ..ops.sparse import CSR
    from .sparse_dist import make_sharded_csr_matvec

    ranks = (list(range(dist.get_world_size())) if devices is None
             else [int(r) for r in devices])
    me = dist.get_rank()
    rng = np.random.default_rng(0)
    results = []
    base_rate = None
    for k in device_counts:
        if k > len(ranks):
            break
        mesh = create_mesh((k,), ("x",), devices=ranks[:k])
        device = mesh_device(mesh)
        n = rows_per_device * k
        Ng = max(int(np.sqrt(n)), 2)
        d = np.ones(n)
        A = sp.diags([d * 4, -d[:-1], -d[:-1], -d[:-Ng], -d[:-Ng]],
                     [0, 1, -1, Ng, -Ng], format="csr")
        A.data = A.data * (1 + 0.1 * rng.standard_normal(A.nnz))
        dt = 0.0
        if me in ranks[:k]:
            csr = CSR(torch.as_tensor(A.data, dtype=dtype, device=device),
                      np.asarray(A.indices, np.int32),
                      np.asarray(A.indptr, np.int32), (n, n))
            mv = make_sharded_csr_matvec(csr, mesh, "x")
            group = mesh.get_group("x")

            def chain(v):
                for _ in range(n_matvecs):
                    w = mv.local(v)
                    top = torch.max(torch.abs(w))
                    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
                    v = w / torch.clamp_min(top, 1.0)
                return v

            v0 = torch.ones(mv.plan.chunk, dtype=dtype, device=device)
            chain(v0)
            _sync(device)
            t0 = time.perf_counter()
            chain(v0)
            _sync(device)
            dt = time.perf_counter() - t0
        slowest = torch.tensor(dt, dtype=torch.float64, device=device)
        dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
        dt = float(slowest)
        rate = n_matvecs * A.nnz / dt
        if base_rate is None:
            base_rate = rate / k
        results.append((k, rate, rate / (base_rate * k)))
    return results

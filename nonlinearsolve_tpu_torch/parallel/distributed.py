"""Explicit per-shard SPMD over a device mesh (the port of
``parallel/distributed.py``'s shard_map tier).

The JAX package's shard_map functions take global arrays sharded on the
mesh and run a per-shard body with ``ppermute`` halo exchanges and ``psum``
reductions.  Here the factories take a ``DeviceMesh`` and return functions
of row-sharded DTensors (a plain tensor, the same on every rank, is
distributed first): the body runs on each rank's ``to_local()`` shard, the
halos travel by ``torch.distributed.batch_isend_irecv`` on the periodic
ring of the mesh axis' process group, reductions by ``all_reduce``, and the
result is wrapped back with ``DTensor.from_local``.  Every rank of the mesh
calls the returned function, as every device runs a shard_map body.  The
stencil factories return a ``PerShard``, whose ``local`` is the body on
local shards.

The GSPMD tier (``distributed_solve``: XLA partitions the whole solve) has
no counterpart here; it raises naming ROADMAP A.31.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from .mesh import replicated, row_sharding


def distributed_solve(prob, alg=None, mesh=None, shard_axis: int = 0, **kw):
    raise NotImplementedError(
        "distributed_solve (the GSPMD tier: a rank-local engine with "
        "all-reduced dots in GMRES) is ROADMAP A.31; the explicit tier "
        "(halo_exchange and the sharded_* factories) is ported")


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def _issue_halo_exchange(group, x_local, width: int = 1):
    """Start the exchange of ``width`` boundary slices with the ring
    neighbours of this rank in ``group``.  Returns ``(left_halo, right_halo,
    works)``: the halos are complete once every work in ``works`` is
    waited for.

    With one rank the ring is the identity permutation, as ``ppermute`` on
    one device is: the shard's own last and first slices come back, with
    no P2P call (c10d refuses a send to one's own rank).  With two, both
    neighbours are one rank: the two sends and the two receives pair by
    issue order (NCCL) and by tag (gloo) — tag 0 travels rightward and
    arrives as the left halo, tag 1 leftward and arrives as the right
    halo."""
    right_send = x_local[-width:].contiguous()
    left_send = x_local[:width].contiguous()
    n = dist.get_world_size(group)
    if n == 1:
        return right_send, left_send, []
    me = dist.get_rank(group)
    left_peer = dist.get_global_rank(group, (me - 1) % n)
    right_peer = dist.get_global_rank(group, (me + 1) % n)
    left_halo = torch.empty_like(right_send)
    right_halo = torch.empty_like(left_send)
    ops = [dist.P2POp(dist.isend, right_send, right_peer, group, tag=0),
           dist.P2POp(dist.isend, left_send, left_peer, group, tag=1),
           dist.P2POp(dist.irecv, left_halo, left_peer, group, tag=0),
           dist.P2POp(dist.irecv, right_halo, right_peer, group, tag=1)]
    return left_halo, right_halo, dist.batch_isend_irecv(ops)


def _wait(works) -> None:
    for work in works:
        work.wait()


def halo_exchange(group, x_local, width: int = 1):
    """Exchange ``width`` boundary slices with the ring neighbours along
    ``group`` (a process group; None is the default one).  Returns
    ``(left_halo, right_halo)``: the last slices of the left neighbour and
    the first slices of the right neighbour (periodic ring)."""
    group = group if group is not None else dist.group.WORLD
    left, right, works = _issue_halo_exchange(group, x_local, width)
    _wait(works)
    return left, right


# ---------------------------------------------------------------------------
# global arrays in and out
# ---------------------------------------------------------------------------

def _shard(x, mesh, axis: str):
    """This rank's row shard of ``x``: a DTensor (redistributed to row
    sharding if it is not) or a plain tensor, the same on every rank
    (distributed first)."""
    placements = row_sharding(mesh, axis, max(x.dim(), 1))
    if isinstance(x, DTensor):
        if list(x.placements) != placements:
            x = x.redistribute(mesh, placements)
        return x.to_local()
    return distribute_tensor(x, mesh, placements).to_local()


class PerShard:
    """A per-shard body lifted to row-sharded DTensors of one mesh axis.

    Calling it takes global arrays (DTensors, or plain tensors the same on
    every rank), runs the body on this rank's shards and returns
    the row-sharded result with the last argument's global shape.
    ``local`` is the body itself, on local shards: a caller that keeps its
    own shards, as the weak-scaling chain does, calls it without DTensor's
    per-call dispatch on the host."""

    def __init__(self, mesh, axis: str, body):
        self.mesh = mesh
        self.axis = axis
        self.local = body

    def __call__(self, *xs):
        out = self.local(*(_shard(x, self.mesh, self.axis) for x in xs))
        like = xs[-1]
        dt = isinstance(like, DTensor)
        return DTensor.from_local(out, self.mesh,
                                  row_sharding(self.mesh, self.axis,
                                               max(out.dim(), 1)),
                                  run_check=False,
                                  shape=like.shape if dt else None,
                                  stride=like.stride() if dt else None)


def sharded_laplacian_1d_factory(mesh, axis: str = "x") -> PerShard:
    """Periodic 1D Laplacian over row shards with ring halos — the
    hand-scheduled analogue of a roll on a sharded axis."""
    group = mesh.get_group(axis)

    def lap(xl):
        left, right = halo_exchange(group, xl)
        xm = torch.cat([left, xl, right])
        return xm[:-2] - 2.0 * xl + xm[2:]

    return PerShard(mesh, axis, lap)


def sharded_rd3d_jvp_factory(mesh, D, N: int, axis: str = "x") -> PerShard:
    """JVP of the 3D reaction–diffusion operator, ``J·t = D Δt + (1 − 3u²) t``
    on the global (N, ny, nx) grid with h = 1/N, the leading (z) axis
    sharded over ``axis``: the roll tier.  The halo exchange of the two
    boundary planes is issued first; the in-plane stencil and the reaction
    term, which do not need it, are computed while it travels; the halos
    are consumed last."""
    group = mesh.get_group(axis)
    h2 = (1.0 / N) ** 2

    def jvp(ul, tl):
        left, right, works = _issue_halo_exchange(group, tl)
        inplane = (torch.roll(tl, 1, 1) + torch.roll(tl, -1, 1)
                   + torch.roll(tl, 1, 2) + torch.roll(tl, -1, 2)
                   - 6.0 * tl)
        reaction = (1.0 - 3.0 * ul ** 2) * tl
        _wait(works)
        up = torch.cat([left, tl[:-1]])
        down = torch.cat([tl[1:], right])
        lap = (inplane + up + down) / h2
        return D * lap + reaction

    return PerShard(mesh, axis, jvp)


def sharded_rd3d_jvp_pallas_factory(mesh, D, N: int, axis: str = "x",
                                    bz: int = 8) -> PerShard:
    """The per-shard kernel tier of the same JVP: the ring exchange of the
    boundary planes, then K11 (``ops.stencil3d.rd3d_jvp_blocked_halo``) on
    each shard with the received planes and h = 1/N.  ``bz`` must divide
    the local nz.  (The name is the JAX package's.)"""
    from ..ops.stencil3d import rd3d_jvp_blocked_halo

    group = mesh.get_group(axis)

    def jvp(ul, tl):
        left, right = halo_exchange(group, tl)
        return rd3d_jvp_blocked_halo(ul, tl, left, right, D, bz=bz,
                                     n_global=N)

    return PerShard(mesh, axis, jvp)


def psum_dot_factory(mesh, axis: str = "x"):
    """Dot product of two row-sharded vectors, all-reduced over ``axis``: a
    0-d DTensor replicated on the mesh (the GMRES / line-search reduction
    primitive)."""
    group = mesh.get_group(axis)

    def pdot(a, b):
        s = torch.dot(_shard(a, mesh, axis), _shard(b, mesh, axis))
        dist.all_reduce(s, group=group)
        return DTensor.from_local(s, mesh, replicated(mesh), run_check=False)

    return pdot

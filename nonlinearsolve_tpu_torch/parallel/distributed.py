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

The GSPMD tier's counterpart, ``distributed_solve``, places the state on
the mesh as a DTensor and runs the ordinary solve on it: torch's DTensor
ops insert the collectives, as XLA's partitioner does for the JAX package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from .. import _backend
from .mesh import replicated, row_sharding


def distributed_solve(prob, alg=None, mesh=None, shard_axis: int = 0, *,
                      abstol=None, reltol=None, maxiters=1000,
                      termination_condition=None):
    """Solve with the state's axis ``shard_axis`` row-partitioned across
    the first axis of ``mesh`` (every rank of the default group by
    default).  ``u0`` becomes a DTensor sharded on that axis, each tensor
    leaf of ``p`` with u0's shape is sharded the same way and every other
    one replicated; then the ordinary ``solve_nonlinear`` runs on these
    global DTensors, as the JAX package runs its ordinary solve under
    GSPMD.  Rolls on the sharded axis and the reductions of the Krylov and
    termination steps become collectives inside torch's DTensor ops; the
    engines' J·v takes reverse mode (``core/autodiff.py``).  Every rank
    calls it with the same problem; ``sol.u`` comes back a DTensor sharded
    on ``shard_axis``."""
    from ..core.solve import _default_algorithm, solve_nonlinear
    from ..utils.pytree import tree_map
    from .mesh import create_mesh

    if mesh is None:
        mesh = create_mesh()
    axis = mesh.mesh_dim_names[0]
    u0 = prob.u0
    sharded = row_sharding(mesh, axis, ndim=u0.dim(), shard_dim=shard_axis)

    def place(x, placements):
        # every rank holds the same tensor: each keeps its own shard, with
        # no communication
        return distribute_tensor(x, mesh, placements, src_data_rank=None)

    def shard_param(x):
        if not isinstance(x, torch.Tensor):
            return x
        if x.shape == u0.shape:
            return place(x, sharded)
        return place(x, replicated(mesh))

    p = tree_map(shard_param, prob.p) if prob.p is not None else None
    prob2 = prob.remake(u0=place(u0, sharded), p=p)
    if alg is None:
        alg = _default_algorithm(prob2)
    return solve_nonlinear(prob2, alg, abstol=abstol, reltol=reltol,
                           maxiters=maxiters,
                           termination_condition=termination_condition)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def _issue_halo_exchange(group, x_local, width: int = 1,
                         right_width: int = None):
    """Start the exchange of boundary slices with the ring neighbours of
    this rank in ``group``: ``width`` slices (along dim 0) arrive from the
    left and ``right_width`` (``width`` by default) from the right.
    Returns ``(left_halo, right_halo, works)``: the halos are complete once
    every work in ``works`` is waited for.

    A width wider than the shard spans several neighbours: hop k brings
    the whole shard of the rank k places away, and the farthest hop only
    the slices still missing (the JAX package's ``ppermute`` hops).  A
    width of 0 issues nothing.  With one rank the ring is the identity
    permutation, as ``ppermute`` on one device is: the shard's own slices
    come back, with no P2P call (c10d refuses a send to one's own rank).
    Hop k leftward-received travels with tag 2(k−1), rightward-received
    with tag 2(k−1)+1, so that gloo pairs the transfers between two ranks
    by tag; every rank issues its sends, then its receives, in the same
    (side, hop) order, which pairs them by issue order under NCCL."""
    hl = int(width)
    hr = hl if right_width is None else int(right_width)
    chunk = x_local.shape[0]
    n = dist.get_world_size(group)
    kl, kr = -(-hl // chunk), -(-hr // chunk)

    def payload(side, k):
        last = kl if side == 0 else kr
        if k < last:
            return x_local
        rem = (hl if side == 0 else hr) - (last - 1) * chunk
        return x_local[-rem:] if side == 0 else x_local[:rem]

    hops = [(0, k) for k in range(kl, 0, -1)] + \
        [(1, k) for k in range(1, kr + 1)]
    if n == 1:
        parts = [payload(side, k).contiguous() for side, k in hops]
        left = torch.cat(parts[:kl]) if kl else x_local[:0]
        right = torch.cat(parts[kl:]) if kr else x_local[:0]
        return left, right, []
    me = dist.get_rank(group)
    left = x_local.new_empty((hl,) + tuple(x_local.shape[1:]))
    right = x_local.new_empty((hr,) + tuple(x_local.shape[1:]))
    sends, recvs = [], []
    at = {0: 0, 1: 0}
    for side, k in sorted(hops):
        # side 0: the left halo, from the rank k places to the left (each
        # rank sends the same piece k places to the right); side 1: mirror
        step = k if side == 0 else -k
        to = dist.get_global_rank(group, (me + step) % n)
        frm = dist.get_global_rank(group, (me - step) % n)
        piece = payload(side, k).contiguous()
        tag = 2 * (k - 1) + side
        sends.append(dist.P2POp(dist.isend, piece, to, group, tag=tag))
        halo = left if side == 0 else right
        width_k = piece.shape[0]
        # left parts lie farthest first; right parts nearest first
        lo = (hl - at[0] - width_k) if side == 0 else at[1]
        at[side] += width_k
        recvs.append(dist.P2POp(dist.irecv, halo[lo:lo + width_k], frm,
                                group, tag=tag))
    for _ in sends:
        _backend.count_collective("p2p_send")
    return left, right, dist.batch_isend_irecv(sends + recvs)


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

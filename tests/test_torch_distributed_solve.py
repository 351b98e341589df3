"""``distributed_solve`` and the dryrun's sharded solve shapes
(``parallel/distributed.py``, ``parallel/sparse_dist.py``, ROADMAP A.31)
against the JAX package on the CPU, in gloo runs of 1, 2 and 4 processes.

This file runs itself as the worker (``python
tests/test_torch_distributed_solve.py --worker RANK WORLD PORT DIR``), with
the JAX package's results computed in the parent and saved in DIR as
``.npy``.  The workers check:

- ``distributed_solve`` on ``reaction_diffusion.make_problem(16)`` (f64,
  GMRES(20), Eisenstat–Walker) within 1e-6 of the JAX package's
  ``distributed_solve`` on its 8 virtual devices, ``sol.u`` a DTensor with
  ``Shard(0)``, and the NLStats of the unsharded solve (worlds 1, 2, 4);
- the banded halo / kernel-tier shape (``__graft_entry__.py``'s shape 4)
  and the config-5 shape (``:260-376``: the Jacobian assembled by colored
  sparse AD each step, applied through the sharded matvec's kernel tier,
  multigrid-preconditioned GMRES(40)) within 1e-6 of the JAX package's
  single-device roots (worlds 2 and 4);
- the 2×2 mesh Brusselator with per-component multigrid
  (``:126-168``) within 1e-5 of the JAX package's single-device root
  (world 4), with K1's J·v and, through ``distributed_solve``, with the
  reverse-over-reverse J·v, which equals the unsharded J·v within 1e-12
  there (ROADMAP C.5);
- the same Brusselator through ``distributed_solve`` with the AD J·v on
  the one-axis mesh, rows or columns sharded (worlds 2 and 4): Success
  within 1e-5 of that root, with the unsharded solve's NLStats, the J·v
  within 1e-12 of the unsharded one (C.6, repaired by
  ``parallel/dtensor_rules.py``).

Sizes are cut for the CPU's time: shape 4 to an 8² grid (the dryrun's
16²), the config-5 shape to 32² (its 128²).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import scipy.sparse as sp
import torch

if __name__ != "__main__":
    # the gloo worker (below) needs only torch
    import jax
    import jax.numpy as jnp

torch.set_num_threads(1)


# the dryrun's constructions (numpy)

def _banded(rng, N):
    n = N * N
    d = np.ones(n)
    A = sp.diags([d * 4, -d[:-1], -d[:-1], -d[:-N], -d[:-N]],
                 [0, 1, -1, N, -N], format="csr")
    A.data = A.data * (1 + 0.1 * rng.standard_normal(A.nnz))
    return A.tocsr()


def _dryrun_shapes_3_4(Ng=8):
    """``__graft_entry__.py``'s scrambled (shape 3) and banded (shape 4)
    operators and right-hand sides, one ``default_rng(0)`` as there."""
    rng = np.random.default_rng(0)
    ns = Ng * Ng
    dg = np.ones(ns)
    Ag = sp.diags([dg * 4, -dg[:-1], -dg[:-1], -dg[:-Ng], -dg[:-Ng]],
                  [0, 1, -1, Ng, -Ng], format="csr")
    Ag.data = Ag.data * (1 + 0.1 * rng.standard_normal(Ag.nnz))
    sg = rng.permutation(ns)
    Ag = Ag[np.ix_(sg, sg)].tocsr()
    b3 = rng.standard_normal(ns)
    A4 = sp.diags([dg * 4, -dg[:-1], -dg[:-1], -dg[:-Ng], -dg[:-Ng]],
                  [0, 1, -1, Ng, -Ng], format="csr")
    A4.data = A4.data * (1 + 0.1 * rng.standard_normal(A4.nnz))
    b4 = rng.standard_normal(ns)
    return (Ag, b3), (A4.tocsr(), b4)


def _config5_pattern(N5):
    """The config-5 shape's interleaved [[5pt, I], [I, 5pt]] pattern."""
    m5 = N5 * N5
    n5 = 2 * m5
    d5 = np.ones(m5)
    L5 = sp.diags([4 * d5, -d5[:-1], -d5[:-1], -d5[:-N5], -d5[:-N5]],
                  [0, 1, -1, N5, -N5], format="csr")
    I5 = sp.identity(m5, format="csr")
    rows, cols = [], []
    for (rr, cc, M) in ((0, 0, L5), (0, 1, I5), (1, 0, I5), (1, 1, L5)):
        Mc = M.tocoo()
        rows.append(2 * Mc.row + rr)
        cols.append(2 * Mc.col + cc)
    patt = sp.csr_matrix((np.ones(sum(r.size for r in rows)),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n5, n5))
    patt.sort_indices()
    return patt


CONFIG5_N = 16
CONFIG5_A, CONFIG5_B, CONFIG5_ALPHA = 1.0, 3.0, 50.0


# ---------------------------------------------------------------------------
# the JAX package's results, for the workers
# ---------------------------------------------------------------------------

def _jax_newton(A, b, mv):
    import nonlinearsolve_tpu as jnls
    bj = jnp.asarray(b)
    prob = jnls.NonlinearProblem(
        jnls.NonlinearFunction(f=lambda u, p: mv(u) + 0.1 * u ** 3 - bj,
                               jvp=lambda v, u, p: mv(v) + 0.3 * u ** 2 * v),
        jnp.zeros(A.shape[0]))
    sol = jnls.solve(prob, jnls.NewtonRaphson(
        linsolve=jnls.LinearSolver(method="gmres", restart=30,
                                   krylov_maxiter=600)),
        abstol=1e-10, maxiters=50)
    assert bool(sol.success)
    return np.asarray(sol.u)


def _jax_csr(A):
    from nonlinearsolve_tpu.ops.sparse import CSR
    return CSR(jnp.asarray(A.data), np.asarray(A.indices, np.int32),
               np.asarray(A.indptr, np.int32), A.shape)


def _jax_references(out_dir):
    import nonlinearsolve_tpu as jnls
    from jax.sharding import Mesh

    from nonlinearsolve_tpu.models import brusselator as jbru
    from nonlinearsolve_tpu.models import reaction_diffusion as jrd
    from nonlinearsolve_tpu.ops.multigrid import multigrid_preconditioner
    from nonlinearsolve_tpu.parallel import distributed_solve
    from nonlinearsolve_tpu.solvers.first_order import \
        EisenstatWalkerForcing

    devs = jax.devices()[:8]
    mesh = Mesh(np.array(devs), ("x",))
    out = {}

    prob = jrd.make_problem(16)
    alg = jnls.NewtonRaphson(
        linsolve=jnls.LinearSolver(method="gmres", restart=20),
        forcing=EisenstatWalkerForcing())
    out["rd16"] = np.asarray(distributed_solve(prob, alg, mesh,
                                               abstol=1e-8).u)

    # __graft_entry__.py's 2D-mesh shape; its single-device root
    N2 = 16
    prob2 = jbru.make_problem(N2, dtype=jnp.float64)
    mg = multigrid_preconditioner((N2, N2), 10.0, 1.0 / (N2 - 1), c=3.0,
                                  bc="periodic")

    def pm(v):
        w = v.reshape(N2, N2, 2)
        return jnp.stack([mg(w[..., 0]), mg(w[..., 1])],
                         axis=-1).reshape(v.shape)
    alg2 = jnls.NewtonRaphson(
        linsolve=jnls.LinearSolver(method="gmres", restart=30,
                                   krylov_maxiter=400, precond_fn=pm),
        forcing=EisenstatWalkerForcing(eta_max=1e-2))
    sol2 = jnls.solve(prob2, alg2, abstol=1e-6, maxiters=200)
    assert bool(sol2.success)
    out["mesh2x2"] = np.asarray(sol2.u)

    # shape 4 (banded, halo, kernel tier), its single-device root
    _, (A4, b4) = _dryrun_shapes_3_4()
    csr4 = _jax_csr(A4)
    out["shape4"] = _jax_newton(A4, b4, csr4.matvec_xla)

    # the config-5 shape's single-device matrix-free root
    from nonlinearsolve_tpu.ops.sparse import CSR
    N5 = CONFIG5_N
    patt = _config5_pattern(N5)
    csr5 = CSR(jnp.zeros(patt.nnz), np.asarray(patt.indices, np.int32),
               np.asarray(patt.indptr, np.int32), patt.shape)
    Ac, Bc, a5 = CONFIG5_A, CONFIG5_B, CONFIG5_ALPHA

    def f5(u):
        U = u.reshape(N5, N5, 2)
        Up = jnp.pad(U, ((1, 1), (1, 1), (0, 0)))
        lap = (Up[:-2, 1:-1] + Up[2:, 1:-1] + Up[1:-1, :-2]
               + Up[1:-1, 2:] - 4.0 * U)
        u0c, v0c = U[..., 0], U[..., 1]
        fu = a5 * lap[..., 0] + Ac + u0c * u0c * v0c - (Bc + 1.0) * u0c
        fv = a5 * lap[..., 1] + Bc * u0c - u0c * u0c * v0c
        return jnp.stack([fu, fv], axis=-1).reshape(-1)

    mg5 = multigrid_preconditioner((N5, N5), a5, 1.0, c=0.0, bc="dirichlet")

    def pm5(v):
        w = v.reshape(N5, N5, 2)
        return jnp.stack([mg5(w[..., 0]), mg5(w[..., 1])],
                         axis=-1).reshape(v.shape)
    U0 = jnp.stack([jnp.full((N5, N5), Ac), jnp.full((N5, N5), Bc / Ac)],
                   axis=-1)
    sol5 = jnls.solve(jnls.NonlinearProblem(
        jnls.NonlinearFunction(f=lambda u, p: f5(u), jac_prototype=csr5),
        U0.reshape(-1)), jnls.NewtonRaphson(linsolve=jnls.LinearSolver(
            method="gmres", restart=40, krylov_maxiter=400,
            precond_fn=pm5)), abstol=1e-8, maxiters=20)
    assert bool(sol5.success)
    out["config5"] = np.asarray(sol5.u)
    for name, a in out.items():
        np.save(os.path.join(out_dir, f"{name}.npy"), a)


@pytest.fixture(scope="module")
def jax_references(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    out = tmp_path_factory.mktemp("jax_distributed_solve")
    _jax_references(str(out))
    return str(out)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(world, ref_dir, deadline):
    """Run ``world`` gloo workers on a free local port; their return codes
    and outputs.  Every worker is killed at ``deadline`` (a
    ``time.monotonic()`` value)."""
    port = str(_free_port())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(world), port, ref_dir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            left = max(deadline - time.monotonic(), 1.0)
            try:
                outs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0] + "\n(killed at the deadline)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


@pytest.mark.parametrize("world", [1, 2, 4])
def test_gloo_workers_match_jax(world, jax_references):
    # another process may take the free port first: up to three tries,
    # all within one deadline
    deadline = time.monotonic() + 240.0
    for _ in range(3):
        rcs, outs = _run_workers(world, jax_references, deadline)
        if not any("ddress already in use" in out for out in outs):
            break
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} of {world}:\n{out}"
        assert f"worker {r}/{world} ok" in out


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _sharded(x, mesh):
    """A plain tensor, the same on every rank, as a row-sharded DTensor
    (each rank keeps its own rows)."""
    from torch.distributed.tensor import Shard, distribute_tensor
    return distribute_tensor(x, mesh, [Shard(0)], src_data_rank=None)


def _csr(A):
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    return CSR(torch.tensor(A.data), np.asarray(A.indices, np.int32),
               np.asarray(A.indptr, np.int32), A.shape)


def _newton_through(mv, b, mesh, n, maxiter=600):
    import nonlinearsolve_tpu_torch as tnls
    bt = _sharded(torch.tensor(b), mesh)
    prob = tnls.NonlinearProblem(
        tnls.NonlinearFunction(f=lambda u, p: mv(u) + 0.1 * u ** 3 - bt,
                               jvp=lambda v, u, p: mv(v) + 0.3 * u ** 2 * v),
        _sharded(torch.zeros(n, dtype=torch.float64), mesh))
    sol = tnls.solve(prob, tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=30,
                                   krylov_maxiter=maxiter)),
        abstol=1e-10, maxiters=50)
    assert sol.retcode == tnls.ReturnCode.Success, sol.retcode
    return sol.u.full_tensor().numpy()


def _check_distributed_solve(mesh, ref):
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.models import reaction_diffusion
    from nonlinearsolve_tpu_torch.parallel import distributed_solve
    from torch.distributed.tensor import DTensor, Shard

    prob = reaction_diffusion.make_problem(16, device="cpu")
    alg = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=20),
        forcing=tnls.EisenstatWalkerForcing())
    sol = distributed_solve(prob, alg, mesh, abstol=1e-8)
    assert sol.retcode == tnls.ReturnCode.Success
    assert isinstance(sol.u, DTensor) and list(sol.u.placements) == [Shard(0)]
    np.testing.assert_allclose(sol.u.full_tensor().numpy(), ref["rd16"],
                               rtol=0, atol=1e-6)
    # the unsharded solve, the same problem: the same NLStats
    plain = tnls.solve(prob, alg, abstol=1e-8)
    assert [int(getattr(sol.stats, k)) for k in ("nf", "nsteps")] == \
        [int(getattr(plain.stats, k)) for k in ("nf", "nsteps")]


def _brusselator_16():
    """The 16² Brusselator of ``__graft_entry__.py``'s 2D-mesh shape: its
    state, parameters and the per-component multigrid-preconditioned
    Newton–GMRES(30)."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.models import brusselator
    from nonlinearsolve_tpu_torch.ops.multigrid import \
        multigrid_preconditioner

    N2 = 16
    u0 = brusselator.init_u0(N2, device="cpu")
    p = brusselator.default_p(N2, device="cpu")
    mg = multigrid_preconditioner((N2, N2), 10.0, 1.0 / (N2 - 1), c=3.0,
                                  bc="periodic")

    def pm(v):
        w = v.reshape(N2, N2, 2)
        return torch.stack([mg(w[..., 0]), mg(w[..., 1])],
                           dim=-1).reshape(v.shape)
    alg = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=30,
                                   krylov_maxiter=400, precond_fn=pm),
        forcing=tnls.EisenstatWalkerForcing(eta_max=1e-2))
    return u0, p, alg


def _ad_jvp_error(mesh, placements, u0, p):
    """The AD J·v of ``brusselator_2d`` at ``u0`` in ``placements`` against
    the unsharded ``torch.func.jvp``: its relative error, after checking
    that the J·v comes back in ``placements`` and the residual equals the
    unsharded one."""
    from nonlinearsolve_tpu_torch.core.autodiff import jvp
    from nonlinearsolve_tpu_torch.models import brusselator
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    f = lambda U: brusselator.brusselator_2d(U, p)   # noqa: E731
    u0s = distribute_tensor(u0, mesh, placements, src_data_rank=None)
    t = torch.randn(u0.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(5))
    v = distribute_tensor(t, mesh, placements, src_data_rank=None)
    with implicit_replication():
        fu, jv = jvp(f, u0s, v)
    assert list(jv.placements) == placements
    assert torch.equal(fu.full_tensor(), f(u0))
    want = torch.func.jvp(f, (u0,), (t,))[1]
    return float((jv.full_tensor() - want).abs().max() / want.abs().max())


def _check_mesh_2x2(ref):
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.models import brusselator
    from nonlinearsolve_tpu_torch.parallel import (create_mesh,
                                                   distributed_solve)
    from torch.distributed.tensor import Shard, distribute_tensor

    mesh2 = create_mesh((2, 2), ("x", "y"))
    u0, p, alg = _brusselator_16()
    placements = [Shard(0), Shard(1)]
    u0s = distribute_tensor(u0, mesh2, placements, src_data_rank=None)
    sol = tnls.solve(brusselator.problem(u0s, p, kernel_jvp=True), alg,
                     abstol=1e-6, maxiters=200)
    assert sol.retcode == tnls.ReturnCode.Success
    assert list(sol.u.placements) == placements
    np.testing.assert_allclose(sol.u.full_tensor().numpy(), ref["mesh2x2"],
                               rtol=0, atol=1e-5)
    # ROADMAP C.5 (repaired): the AD J·v through torch.stack on this mesh
    # equals the unsharded one, and a distributed_solve with it converges
    err = _ad_jvp_error(mesh2, placements, u0, p)
    assert err <= 1e-12, err
    sol_ad = distributed_solve(brusselator.problem(u0, p, kernel_jvp=False),
                               alg, mesh2, abstol=1e-6, maxiters=200)
    assert sol_ad.retcode == tnls.ReturnCode.Success
    np.testing.assert_allclose(sol_ad.u.full_tensor().numpy(),
                               ref["mesh2x2"], rtol=0, atol=1e-5)


def _check_one_axis_flagship(mesh, ref):
    """ROADMAP C.6 (repaired): on a one-axis mesh, ``distributed_solve`` of
    the Brusselator with the AD J·v (its residual selects and stacks its
    components) with the state's rows and with its columns sharded.  Each
    ends Success with ``sol.u`` in the requested placement, within 1e-5 of
    the JAX package's root and with the NLStats of the unsharded solve; its
    J·v is within 1e-12 of the unsharded J·v."""
    import dataclasses

    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.models import brusselator
    from nonlinearsolve_tpu_torch.parallel import distributed_solve
    from torch.distributed.tensor import DTensor, Shard

    u0, p, alg = _brusselator_16()
    prob = brusselator.problem(u0, p, kernel_jvp=False)
    plain = tnls.solve(prob, alg, abstol=1e-6, maxiters=200)
    assert plain.retcode == tnls.ReturnCode.Success
    for axis in (0, 1):
        err = _ad_jvp_error(mesh, [Shard(axis)], u0, p)
        assert err <= 1e-12, (axis, err)
        sol = distributed_solve(prob, alg, mesh, shard_axis=axis,
                                abstol=1e-6, maxiters=200)
        assert sol.retcode == tnls.ReturnCode.Success, (axis, sol.retcode)
        assert isinstance(sol.u, DTensor)
        assert list(sol.u.placements) == [Shard(axis)]
        np.testing.assert_allclose(sol.u.full_tensor().numpy(),
                                   ref["mesh2x2"], rtol=0, atol=1e-5)
        assert dataclasses.asdict(sol.stats) == \
            dataclasses.asdict(plain.stats), (axis, sol.stats, plain.stats)


def _check_dryrun_shape4(mesh, ref):
    from nonlinearsolve_tpu_torch.parallel import make_sharded_csr_matvec
    _, (A4, b4) = _dryrun_shapes_3_4()
    mv = make_sharded_csr_matvec(_csr(A4), mesh, "x", use_pallas=True)
    assert mv.plan.mode == "halo" and mv.tier == "pallas"
    u = _newton_through(mv, b4, mesh, A4.shape[0], maxiter=400)
    np.testing.assert_allclose(u, ref["shape4"], rtol=0, atol=1e-6)


def _check_config5(mesh, ref):
    """The dryrun's config-5 loop at 16²: the Jacobian assembled by colored
    sparse AD each step, applied through the sharded matvec (the kernel
    tier), multigrid-preconditioned GMRES(40)."""
    import torch.nn.functional as F

    from nonlinearsolve_tpu_torch.ops.krylov import gmres
    from nonlinearsolve_tpu_torch.ops.multigrid import \
        multigrid_preconditioner
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    from nonlinearsolve_tpu_torch.ops.sparse_jac import plan_sparse_jacobian
    from nonlinearsolve_tpu_torch.parallel import make_sharded_csr_matvec
    from torch.distributed.tensor.experimental import implicit_replication

    N5 = CONFIG5_N
    n5 = 2 * N5 * N5
    Ac, Bc, a5 = CONFIG5_A, CONFIG5_B, CONFIG5_ALPHA
    patt = _config5_pattern(N5)
    csr5 = CSR(torch.zeros(patt.nnz, dtype=torch.float64),
               np.asarray(patt.indices, np.int32),
               np.asarray(patt.indptr, np.int32), patt.shape)

    def f5(u):
        U = u.reshape(N5, N5, 2)
        Up = F.pad(U, (0, 0, 1, 1, 1, 1))
        lap = (Up[:-2, 1:-1] + Up[2:, 1:-1] + Up[1:-1, :-2]
               + Up[1:-1, 2:] - 4.0 * U)
        u0c, v0c = U[..., 0], U[..., 1]
        fu = a5 * lap[..., 0] + Ac + u0c * u0c * v0c - (Bc + 1.0) * u0c
        fv = a5 * lap[..., 1] + Bc * u0c - u0c * u0c * v0c
        return torch.stack([fu, fv], dim=-1).reshape(-1)

    jac5 = plan_sparse_jacobian(f5, n5, n5, sparsity=csr5, device="cpu")
    mv5 = make_sharded_csr_matvec(csr5, mesh, "x", use_pallas=True)
    assert mv5.plan.mode == ("allgather" if mesh.size() == 1 else "halo")
    mg5 = multigrid_preconditioner((N5, N5), a5, 1.0, c=0.0, bc="dirichlet")

    def pm5(v):
        w = v.reshape(N5, N5, 2)
        return torch.stack([mg5(w[..., 0]), mg5(w[..., 1])],
                           dim=-1).reshape(v.shape)
    u = torch.stack([torch.full((N5, N5), Ac, dtype=torch.float64),
                     torch.full((N5, N5), Bc / Ac, dtype=torch.float64)],
                    dim=-1).reshape(-1)
    for _ in range(20):
        J = jac5(f5, u)
        r = f5(u)
        with implicit_replication():
            res = gmres(lambda v: mv5(v, data=J.data), -_sharded(r, mesh),
                        M=pm5, rtol=1e-6, restart=40, maxiter=400)
        u = u + res.x.full_tensor()
        if float(r.abs().max()) <= 1e-8:
            break
    assert float(f5(u).abs().max()) <= 1e-8
    np.testing.assert_allclose(u.numpy(), ref["config5"], rtol=0, atol=1e-6)


def _worker(rank, world, port, ref_dir):
    """One rank of the gloo run: every check raises on a mismatch."""
    import torch.distributed as dist

    from nonlinearsolve_tpu_torch.parallel import create_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        ref = {name[:-4]: np.load(os.path.join(ref_dir, name))
               for name in os.listdir(ref_dir)}
        mesh = create_mesh()
        _check_distributed_solve(mesh, ref)
        if world in (2, 4):
            _check_dryrun_shape4(mesh, ref)
            _check_config5(mesh, ref)
            _check_one_axis_flagship(mesh, ref)
        if world == 4:
            _check_mesh_2x2(ref)
    finally:
        dist.destroy_process_group()
    print(f"worker {rank}/{world} ok", flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

"""The port's distributed layer (``nonlinearsolve_tpu_torch.parallel``) and
K11 (``rd3d_jvp_blocked_halo``) on the CPU against the JAX package.

- K11's plain version (the wrapper takes it for CPU tensors) against the
  JAX kernel in interpret mode at 16³ f64, with wrapped and with foreign
  halo planes, atol 1e-11 (the same operations in the same order); the
  ``bz`` error.
- The port's per-shard K11 on 8 z-slabs, each given its neighbours'
  planes, against JAX's ``sharded_rd3d_jvp_pallas_factory`` on the
  conftest's 8 virtual devices, atol 1e-11; and bit-equal to K9 (plain) on
  the whole grid.
- gloo runs of 1, 2 and 4 processes: this file runs itself as the worker
  (``python tests/test_torch_parallel.py --worker RANK WORLD PORT DIR``).
  Each worker checks ``halo_exchange`` on the ring, and
  ``psum_dot_factory``, ``sharded_laplacian_1d_factory`` and both 3D
  factories on z-sharded DTensors against the JAX package's outputs, which
  the parent saved in DIR as ``.npy`` (atol 1e-12; the per-shard kernel
  tier 1e-11), and the shape of ``weak_scaling_report([1, 2], base_n=8,
  n_matvecs=3, use_pallas=True, bz=4)``, as tests/test_parallel.py:172-185
  does.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    # the gloo worker (below) needs only torch
    import jax
    import jax.numpy as jnp

    from nonlinearsolve_tpu.ops import pallas_stencil3d as jst
    from nonlinearsolve_tpu_torch import _backend
    from nonlinearsolve_tpu_torch.ops import stencil3d as tst

N, D = 16, 0.01


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.random(shape), rng.standard_normal(shape)


def _slabs(t, S):
    """(slab, lo, hi) of S z-slabs of the periodic grid t: each slab's
    neighbours' boundary planes."""
    nz = t.shape[0] // S
    out = []
    for s in range(S):
        z0 = s * nz
        lo = t[(z0 - 1) % t.shape[0]][None]
        hi = t[(z0 + nz) % t.shape[0]][None]
        out.append((slice(z0, z0 + nz), lo, hi))
    return out


@pytest.mark.parametrize("bz", [4, 8])
def test_k11_matches_jax_with_wrapped_halos(bz):
    u, t = _inputs((N, N, N), bz)
    ref = jst.rd3d_jvp_blocked_halo(jnp.asarray(u), jnp.asarray(t),
                                    jnp.asarray(t[-1:]), jnp.asarray(t[:1]),
                                    D, bz=bz, n_global=N)
    tt = torch.tensor(t)
    got = tst.rd3d_jvp_blocked_halo(torch.tensor(u), tt, tt[-1:], tt[:1], D,
                                    bz=bz, n_global=N)
    assert got.dtype == torch.float64 and tuple(got.shape) == u.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-11)
    # with wrapped halos it is K9 on the periodic grid
    np.testing.assert_allclose(
        got.numpy(), tst.rd3d_jvp_blocked_plain(torch.tensor(u), tt,
                                                D).numpy(), rtol=0, atol=0)


def test_k11_matches_jax_with_foreign_halos():
    """A shard of 8 planes of a 32-plane grid: the halo planes are not the
    shard's own, and h = 1/32."""
    u, t = _inputs((8, N, N), 7)
    rng = np.random.default_rng(8)
    lo, hi = rng.standard_normal((1, N, N)), rng.standard_normal((1, N, N))
    D_t = np.float64(0.05)
    ref = jst.rd3d_jvp_blocked_halo(jnp.asarray(u), jnp.asarray(t),
                                    jnp.asarray(lo), jnp.asarray(hi),
                                    jnp.asarray(D_t), bz=4, n_global=32)
    got = tst.rd3d_jvp_blocked_halo(
        torch.tensor(u), torch.tensor(t), torch.tensor(lo), torch.tensor(hi),
        torch.tensor(D_t), bz=4, n_global=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-11)


@pytest.mark.parametrize("bz", [3, 16])
def test_k11_bz_must_divide_local_nz(bz):
    u, t = _inputs((8, 8, 8), 0)
    tt = torch.tensor(t)
    with pytest.raises(ValueError, match="must divide local Nz"):
        tst.rd3d_jvp_blocked_halo(torch.tensor(u), tt, tt[-1:], tt[:1], D,
                                  bz=bz)
    with pytest.raises(ValueError, match="must divide local Nz"):
        jst.rd3d_jvp_blocked_halo(jnp.asarray(u), jnp.asarray(t),
                                  jnp.asarray(t[-1:]), jnp.asarray(t[:1]), D,
                                  bz=bz)


def test_k11_on_slabs_matches_jax_pallas_factory():
    """8 z-slabs of 2 planes through the port's K11 (plain) against JAX's
    per-shard Pallas tier on 8 virtual devices; the slabs together are K9
    on the whole grid, bit for bit."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from nonlinearsolve_tpu.parallel.distributed import \
        sharded_rd3d_jvp_pallas_factory
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    u, t = _inputs((N, N, N), 1)
    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    sh = NamedSharding(mesh, P("x"))
    jvp = sharded_rd3d_jvp_pallas_factory(mesh, D, N, bz=2)
    ref = np.asarray(jax.jit(jvp)(jax.device_put(jnp.asarray(u), sh),
                                  jax.device_put(jnp.asarray(t), sh)))
    tu, tt = torch.tensor(u), torch.tensor(t)
    got = torch.cat([tst.rd3d_jvp_blocked_halo(tu[z], tt[z], lo, hi, D, bz=2,
                                               n_global=N)
                     for z, lo, hi in _slabs(tt, 8)])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-11)
    assert torch.equal(got, tst.rd3d_jvp_blocked_plain(tu, tt, D))


def test_k11_cpu_path_launches_no_kernel():
    before = dict(_backend.LAUNCHES)
    u, t = (torch.tensor(a) for a in _inputs((8, 8, 8), 2))
    tst.rd3d_jvp_blocked_halo(u, t, t[-1:], t[:1], D, bz=4)
    assert _backend.LAUNCHES == before


def test_parallel_names_still_open_raise():
    """The four names that raised until ROADMAP A.31 run on a one-rank
    gloo group: the plan, the sharded matvec, ``distributed_solve`` and
    the sparse weak-scaling report."""
    import scipy.sparse as sp
    import torch.distributed as dist

    from nonlinearsolve_tpu_torch import parallel
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    from nonlinearsolve_tpu_torch.parallel import scaling

    A = sp.random(40, 40, density=0.1, random_state=0, format="csr") \
        + 4.0 * sp.identity(40, format="csr")
    plan = parallel.build_sharded_csr_plan(A.indptr, A.indices, 40, 1)
    assert (plan.n, plan.chunk, plan.mode) == (40, 40, "allgather")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = parallel.create_mesh()
        mv = parallel.make_sharded_csr_matvec(
            CSR(torch.tensor(A.data), A.indices, A.indptr, (40, 40)), mesh)
        x = np.arange(40.0)
        np.testing.assert_allclose(mv(torch.tensor(x)).full_tensor().numpy(),
                                   A @ x, rtol=1e-13)
        sol = parallel.distributed_solve(
            _sqrt_problem(), _gmres_newton(), mesh, abstol=1e-12)
        assert int(sol.retcode) == 1
        np.testing.assert_allclose(sol.u.full_tensor().numpy(),
                                   np.sqrt([1.0, 2.0, 3.0, 4.0]), rtol=1e-12)
        rows = scaling.weak_scaling_sparse_report([1], rows_per_device=64,
                                                  n_matvecs=2)
        assert len(rows) == 1 and rows[0][0] == 1 and rows[0][1] > 0
    finally:
        dist.destroy_process_group()


def _sqrt_problem():
    import nonlinearsolve_tpu_torch as tnls
    return tnls.NonlinearProblem(
        lambda u, p: u * u - p, torch.ones(4, dtype=torch.float64),
        torch.tensor([1.0, 2.0, 3.0, 4.0], dtype=torch.float64))


def _gmres_newton():
    import nonlinearsolve_tpu_torch as tnls
    return tnls.NewtonRaphson(linsolve=tnls.LinearSolver(method="gmres"))


# ---------------------------------------------------------------------------
# gloo runs
# ---------------------------------------------------------------------------

def _jax_references(out_dir):
    """The JAX package's explicit tier on its virtual devices (all of them;
    16 planes split evenly), saved for the workers."""
    from nonlinearsolve_tpu.parallel import (create_mesh, psum_dot_factory,
                                             sharded_laplacian_1d_factory)
    from nonlinearsolve_tpu.parallel.distributed import (
        sharded_rd3d_jvp_factory, sharded_rd3d_jvp_pallas_factory)
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = create_mesh()
    sh = NamedSharding(mesh, P("x"))
    x = np.arange(32.0)
    u, t = _inputs((N, N, N), 11)
    ju, jt = (jax.device_put(jnp.asarray(a), sh) for a in (u, t))
    arrays = {
        "x": x, "u": u, "t": t,
        "lap": sharded_laplacian_1d_factory(mesh)(
            jax.device_put(jnp.asarray(x), sh)),
        "dot": psum_dot_factory(mesh)(jnp.asarray(x), jnp.asarray(x)),
        "rd3d": jax.jit(sharded_rd3d_jvp_factory(mesh, D, N))(ju, jt),
        "rd3d_kernel": jax.jit(sharded_rd3d_jvp_pallas_factory(
            mesh, D, N, bz=2))(ju, jt),
    }
    for name, a in arrays.items():
        np.save(os.path.join(out_dir, f"{name}.npy"), np.asarray(a))


@pytest.fixture(scope="module")
def jax_references(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_parallel")
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
    deadline = time.monotonic() + 120.0
    for _ in range(3):
        rcs, outs = _run_workers(world, jax_references, deadline)
        if not any("ddress already in use" in out for out in outs):
            break
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"rank {r} of {world}:\n{out}"
        assert f"worker {r}/{world} ok" in out


def _worker(rank, world, port, ref_dir):
    """One rank of the gloo run: every check raises on a mismatch."""
    import torch.distributed as dist

    from nonlinearsolve_tpu_torch import _backend, interop
    from nonlinearsolve_tpu_torch.parallel import (
        create_mesh, halo_exchange, psum_dot_factory, replicated,
        row_sharding, sharded_laplacian_1d_factory, sharded_rd3d_jvp_factory,
        sharded_rd3d_jvp_pallas_factory)
    from nonlinearsolve_tpu_torch.parallel.scaling import weak_scaling_report

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        ref = {name[:-4]: np.load(os.path.join(ref_dir, name))
               for name in os.listdir(ref_dir)}
        mesh = create_mesh()
        assert mesh.size() == world
        assert [type(p).__name__ for p in row_sharding(mesh, "x", 3)] \
            == ["Shard"]
        assert [type(p).__name__ for p in replicated(mesh)] == ["Replicate"]

        # the ring: the left halo is the left neighbour's last two planes,
        # the right halo the right neighbour's first two
        x_local = torch.arange(3 * 2, dtype=torch.float64).reshape(3, 2) \
            + 100.0 * rank
        left, right = halo_exchange(mesh.get_group("x"), x_local, width=2)
        lr, rr = (rank - 1) % world, (rank + 1) % world
        assert torch.equal(left, torch.arange(2.0, 6.0).reshape(2, 2)
                           .double() + 100.0 * lr), left
        assert torch.equal(right, torch.arange(0.0, 4.0).reshape(2, 2)
                           .double() + 100.0 * rr), right

        rows = slice(rank * 32 // world, (rank + 1) * 32 // world)
        xs = interop.shard_from_numpy(ref["x"], mesh)
        assert tuple(xs.shape) == (32,)
        np.testing.assert_array_equal(xs.to_local().numpy(), ref["x"][rows])
        lap = sharded_laplacian_1d_factory(mesh)(xs)
        np.testing.assert_allclose(lap.to_local().numpy(), ref["lap"][rows],
                                   rtol=0, atol=1e-12)
        # a plain tensor, the same on every rank, is distributed first
        lap2 = sharded_laplacian_1d_factory(mesh)(torch.tensor(ref["x"]))
        assert torch.equal(lap2.to_local(), lap.to_local())
        dot = psum_dot_factory(mesh)(xs, xs)
        np.testing.assert_allclose(float(dot.to_local()), float(ref["dot"]),
                                   rtol=1e-14)

        zrows = slice(rank * N // world, (rank + 1) * N // world)
        u, t = (interop.shard_from_numpy(ref[k], mesh) for k in ("u", "t"))
        out = sharded_rd3d_jvp_factory(mesh, D, N)(u, t)
        assert tuple(out.shape) == (N, N, N)
        np.testing.assert_allclose(out.to_local().numpy(),
                                   ref["rd3d"][zrows], rtol=0, atol=1e-12)
        before = dict(_backend.LAUNCHES)
        out_k = sharded_rd3d_jvp_pallas_factory(mesh, D, N, bz=2)(u, t)
        np.testing.assert_allclose(out_k.to_local().numpy(),
                                   ref["rd3d_kernel"][zrows], rtol=0,
                                   atol=1e-11)
        assert _backend.LAUNCHES == before      # the CPU: plain K11
        # the per-shard body on this rank's own shards is the same product
        local = sharded_rd3d_jvp_pallas_factory(mesh, D, N, bz=2).local(
            u.to_local(), t.to_local())
        assert torch.equal(local, out_k.to_local())

        for use_pallas in (True, False):
            rep = weak_scaling_report([1, 2], base_n=8, n_matvecs=3,
                                      use_pallas=use_pallas, bz=4)
            assert [k for k, _, _ in rep] == [1, 2][:min(world, 2)]
            assert all(r > 0 and np.isfinite(e) for _, r, e in rep)
            assert rep[0][2] == 1.0
    finally:
        dist.destroy_process_group()
    print(f"worker {rank}/{world} ok", flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

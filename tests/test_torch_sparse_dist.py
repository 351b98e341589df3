"""The row-partitioned CSR matvec (``parallel/sparse_dist.py``),
``weak_scaling_sparse_report`` and ``solve_ensemble(mesh=)`` (ROADMAP A.31
and A.29's ``mesh=``) against the JAX package on the CPU.
(``tests/test_torch_distributed_solve.py`` holds ``distributed_solve`` and
the dryrun's sharded solve shapes.)

- Host only: every field of ``build_sharded_csr_plan`` that the port keeps
  equals the JAX plan's (banded, scrambled, wide-band multi-hop and
  non-divisible patterns at S = 1, 2, 3, 4, 8), and each shard's local CSR
  tables (row pointers, buffer columns, data offsets) applied to its x
  buffer give A·x's rows; the ring's hops on one rank.
- gloo runs of 1, 2 and 4 processes: this file runs itself as the worker
  (``python tests/test_torch_sparse_dist.py --worker RANK WORLD PORT
  DIR``), with the JAX package's Newton roots computed in the parent (its
  sharded matvec on 8 virtual devices) and saved in DIR as ``.npy``.  The
  workers check both tiers against scipy at 1e-12 (all patterns, a plain
  and a DTensor x), fresh data on the same plan, the collectives a product
  issues (halo mode: one P2P send a hop; allgather mode: one
  ``all_gather`` of x), Newton–GMRES(30) through the sharded matvec
  within 1e-6 of the JAX package's roots, ``weak_scaling_sparse_report``'s
  rows, and ``solve_ensemble(mesh=)`` rows equal to the unsharded
  ensemble's.

The Newton problems are the JAX tests' (``tests/test_sparse_dist.py``)
with their sizes cut for the CPU's time, each in the same code path: 8²
grids (the JAX tests' 24²), and the wide band at n = 256 with bandwidth 80
(its 1024 and 200), still two hops a side at S = 4.
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

    from nonlinearsolve_tpu.parallel import sparse_dist as jsd
    from nonlinearsolve_tpu_torch.ops import spmv as tspmv
    from nonlinearsolve_tpu_torch.parallel import sparse_dist as tsd

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the patterns (numpy; the JAX tests' constructions)
# ---------------------------------------------------------------------------

def _banded(rng, N):
    n = N * N
    d = np.ones(n)
    A = sp.diags([d * 4, -d[:-1], -d[:-1], -d[:-N], -d[:-N]],
                 [0, 1, -1, N, -N], format="csr")
    A.data = A.data * (1 + 0.1 * rng.standard_normal(A.nnz))
    return A.tocsr()


def _scrambled(rng, N):
    A = _banded(rng, N)
    sg = rng.permutation(A.shape[0])
    return A[np.ix_(sg, sg)].tocsr()


def _wide(rng, n, bw):
    d = np.ones(n)
    A = sp.diags([d * 4, -d[:-1], -d[:-1], -d[:-bw], -d[:-bw]],
                 [0, 1, -1, bw, -bw], format="csr")
    A.data = A.data * (1 + 0.1 * rng.standard_normal(A.nnz))
    return A.tocsr()


def _pattern(name):
    if name == "banded":
        return _banded(np.random.default_rng(0), 40)
    if name == "scrambled":
        return _scrambled(np.random.default_rng(0), 40)
    if name == "wide":
        return _wide(np.random.default_rng(7), 1024, 200)
    if name == "wide_small":
        return _wide(np.random.default_rng(8), 256, 80)
    A = _banded(np.random.default_rng(1), 40)            # non-divisible
    n = A.shape[0] - 37
    return A[:n, :n].tocsr()


# the Newton problems: (pattern, seed), the JAX tests' with the sizes cut
NEWTON = {
    "scrambled": lambda rng: _scrambled(rng, 8),
    "banded": lambda rng: _banded(rng, 8),
    "wide": lambda rng: _wide(rng, 256, 80),
}
NEWTON_SEEDS = {"scrambled": 3, "banded": 4, "wide": 8}


def _newton_problem(name):
    rng = np.random.default_rng(NEWTON_SEEDS[name])
    A = NEWTON[name](rng)
    return A, rng.standard_normal(A.shape[0])


# ---------------------------------------------------------------------------
# host-only: the plan
# ---------------------------------------------------------------------------

PLAN_FIELDS = ("n", "n_shards", "chunk", "mode", "hl", "hr", "buf_len",
               "ntiles", "w", "W", "nx_rows", "kmode", "pallas_ok")


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", ["banded", "scrambled", "wide",
                                  "nondivisible"])
def test_plan_matches_jax(name, S):
    A = _pattern(name)
    n = A.shape[0]
    jplan = jsd.build_sharded_csr_plan(A.indptr, A.indices, n, S)
    tplan = tsd.build_sharded_csr_plan(A.indptr, A.indices, n, S)
    for field in PLAN_FIELDS:
        assert getattr(tplan, field) == getattr(jplan, field), field
    for field in ("seg_pos", "seg_row", "seg_src", "seg_valid"):
        a, b = getattr(tplan, field), getattr(jplan, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert tsd.build_sharded_csr_plan(A.indptr, A.indices, n, S) is tplan

    # each shard's local CSR on its x buffer gives its rows of A·x
    x = np.random.default_rng(S).standard_normal(n)
    xp = np.zeros(S * tplan.chunk)
    xp[:n] = x
    y = A @ x
    for s in range(S):
        if tplan.mode == "halo":
            lo = s * tplan.chunk - tplan.hl
            buf = xp[np.arange(lo, lo + tplan.buf_len) % xp.size]
        else:
            buf = xp
        nnz = int(tplan.shard_indptr[s, -1])
        ys = tspmv.gather_spmv_plain(
            torch.tensor(tplan.shard_indptr[s].astype(np.int32)),
            torch.tensor(tplan.seg_pos[s, :nnz]),
            torch.tensor(A.data[tplan.seg_src[s, :nnz]]),
            torch.tensor(buf)).numpy()
        rows = slice(s * tplan.chunk, min((s + 1) * tplan.chunk, n))
        np.testing.assert_allclose(ys[:max(rows.stop - rows.start, 0)],
                                   y[rows], rtol=1e-13, atol=1e-13)


def test_wide_band_is_multi_hop_and_caches_clear():
    A = _pattern("wide")
    plan = tsd.build_sharded_csr_plan(A.indptr, A.indices, A.shape[0], 8)
    assert plan.mode == "halo" and plan.hl > plan.chunk
    tspmv.clear_plan_caches()
    assert not tsd._PLAN_CACHE
    assert tsd.build_sharded_csr_plan(A.indptr, A.indices, A.shape[0],
                                      8) is not plan


def test_halo_exchange_hops_on_one_rank_are_the_identity_ring():
    """With one rank, k hops of the ring bring the shard's own slices, as
    ``ppermute`` on one device does (no P2P call)."""
    import torch.distributed as dist

    from nonlinearsolve_tpu_torch import _backend
    from nonlinearsolve_tpu_torch.parallel.distributed import \
        _issue_halo_exchange
    store = dist.HashStore()
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        x = torch.arange(5.0)
        _backend.reset_counters()
        left, right, works = _issue_halo_exchange(dist.group.WORLD, x, 7, 3)
        assert works == [] and _backend.COLLECTIVES["p2p_send"] == 0
        assert left.tolist() == [3.0, 4.0, 0.0, 1.0, 2.0, 3.0, 4.0]
        assert right.tolist() == [0.0, 1.0, 2.0]
        left, right, _ = _issue_halo_exchange(dist.group.WORLD, x, 0, 0)
        assert left.numel() == 0 and right.numel() == 0
    finally:
        dist.destroy_process_group()


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
    from jax.sharding import Mesh

    devs = jax.devices()[:8]
    mesh = Mesh(np.array(devs), ("x",))
    out = {}
    for name in NEWTON:
        A, b = _newton_problem(name)
        mv = jsd.make_sharded_csr_matvec(_jax_csr(A), mesh, "x")
        out[f"newton_{name}"] = _jax_newton(A, b, mv)

    for name, a in out.items():
        np.save(os.path.join(out_dir, f"{name}.npy"), a)


@pytest.fixture(scope="module")
def jax_references(tmp_path_factory):
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest's 8 virtual devices")
    out = tmp_path_factory.mktemp("jax_sparse_dist")
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


def _check_matvecs(mesh, world):
    from nonlinearsolve_tpu_torch import _backend
    from nonlinearsolve_tpu_torch.parallel import make_sharded_csr_matvec
    from torch.distributed.tensor import DTensor, Shard

    for name in ("banded", "scrambled", "wide", "wide_small",
                 "nondivisible"):
        A = _pattern(name)
        n = A.shape[0]
        x = np.random.default_rng(5).standard_normal(n)
        for use_pallas in (False, True):
            mv = make_sharded_csr_matvec(_csr(A), mesh, "x",
                                         use_pallas=use_pallas)
            assert mv.tier == ("pallas" if use_pallas else "segment_sum")
            _backend.reset_counters()
            y = mv(torch.tensor(x))
            sends = _backend.COLLECTIVES["p2p_send"]
            gathers = _backend.COLLECTIVES["all_gather"]
            assert isinstance(y, DTensor) and tuple(y.shape) == (n,)
            assert list(y.placements) == [Shard(0)]
            np.testing.assert_allclose(y.full_tensor().numpy(), A @ x,
                                       rtol=1e-12, atol=1e-12)
            # the collectives of one product
            plan = mv.plan
            if world == 1:
                assert plan.mode == "allgather" and sends == gathers == 0
            elif plan.mode == "halo":
                hops = -(-plan.hl // plan.chunk) + -(-plan.hr // plan.chunk)
                assert gathers == 0 and sends == hops, (sends, hops)
            else:
                assert sends == 0 and gathers == 1
            # a row-sharded DTensor input gives the same product
            y2 = mv(_sharded(torch.tensor(x), mesh))
            assert torch.equal(y2.full_tensor(), y.full_tensor())
            # fresh data on the same plan, no replanning
            y3 = mv(torch.tensor(x), data=torch.tensor(2.0 * A.data))
            np.testing.assert_allclose(y3.full_tensor().numpy(),
                                       2.0 * (A @ x), rtol=1e-12,
                                       atol=1e-12)
        if world >= 2:
            want = {"banded": "halo", "scrambled": "allgather",
                    "wide": "halo"}.get(name)
            assert want is None or mv.plan.mode == want, (name, mv.plan)
        if name == "wide_small" and world == 4:
            assert mv.plan.hl > mv.plan.chunk     # two hops a side


def _check_newton(mesh, world, ref):
    from nonlinearsolve_tpu_torch.parallel import make_sharded_csr_matvec
    # each world takes the cases its mesh makes distinct: allgather on one
    # rank, the halo (kernel tier) on two, the two-hop halo on four
    cases = {1: [("scrambled", None), ("banded", True)],
             2: [("banded", True)],
             4: [("wide", None), ("scrambled", None)]}[world]
    for name, use_pallas in cases:
        A, b = _newton_problem(name)
        mv = make_sharded_csr_matvec(_csr(A), mesh, "x",
                                     use_pallas=use_pallas)
        u = _newton_through(mv, b, mesh, A.shape[0])
        np.testing.assert_allclose(u, ref[f"newton_{name}"], rtol=0,
                                   atol=1e-6)
        assert np.abs(A @ u + 0.1 * u ** 3 - b).max() <= 1e-8


def _check_report_and_ensemble(world):
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.parallel import create_mesh
    from nonlinearsolve_tpu_torch.parallel.scaling import \
        weak_scaling_sparse_report
    from torch.distributed.tensor import DTensor, Shard

    rows = weak_scaling_sparse_report([1, 2, 4], rows_per_device=512,
                                      n_matvecs=3)
    assert [k for k, _, _ in rows] == [1, 2, 4][:{1: 1, 2: 2, 4: 3}[world]]
    assert all(r > 0 and np.isfinite(e) for _, r, e in rows)
    assert rows[0][2] == 1.0

    mesh = create_mesh(axis_names=("batch",))
    u0s = torch.tensor(np.random.default_rng(0).uniform(0.5, 2.0, (8, 2)))
    ps = torch.tensor(np.random.default_rng(1).uniform(1.0, 3.0, 8))
    prob = tnls.NonlinearProblem(lambda u, p: u * u - p,
                                 torch.ones(2, dtype=torch.float64), 2.0)
    for alg in (tnls.NewtonRaphson(), tnls.SimpleNewtonRaphson()):
        ref = tnls.solve_ensemble(prob, alg, u0s=u0s, ps=ps)
        got = tnls.solve_ensemble(prob, alg, u0s=u0s, ps=ps, mesh=mesh)
        assert isinstance(got.u, DTensor)
        assert list(got.u.placements) == [Shard(0)]
        assert torch.equal(got.u.full_tensor(), ref.u)
        assert torch.equal(got.retcode.full_tensor(), ref.retcode)
        for k in ("nf", "njacs", "nsteps"):
            assert torch.equal(getattr(got.stats, k).full_tensor(),
                               getattr(ref.stats, k))
    if world == 4:
        try:
            tnls.solve_ensemble(prob, tnls.NewtonRaphson(), u0s=u0s[:6],
                                mesh=mesh)
        except ValueError as e:
            assert "does not split" in str(e)
        else:
            raise AssertionError("a batch of 6 split over 4 ranks")


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
        _check_matvecs(mesh, world)
        _check_newton(mesh, world, ref)
        _check_report_and_ensemble(world)
    finally:
        dist.destroy_process_group()
    print(f"worker {rank}/{world} ok", flush=True)


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

"""The port's CUDA kernels on the card, against their plain PyTorch
versions.  This file imports neither JAX nor the JAX package, so it runs
on a machine with a GPU and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test needs a CUDA device and skips without one.

Tolerances: f64 rel-inf 1e-12 (same operations, the Laplacian's sum
order); f32 rel-inf 1e-5 of max|out| (nvcc contracts a*b+c into FMA); the
absmax rtol 1e-12 / 1e-6.
"""

import numpy as np
import pytest
import torch

from nonlinearsolve_tpu_torch import _backend
from nonlinearsolve_tpu_torch.models import brusselator as tbru
from nonlinearsolve_tpu_torch.ops import stencil as tst

RTOL = {"float64": 1e-12, "float32": 1e-5}
MAX_RTOL = {"float64": 1e-12, "float32": 1e-6}
TORCH_DT = {"float64": torch.float64, "float32": torch.float32}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(N, dtype, seed, device):
    dt = TORCH_DT[dtype]
    gen = torch.Generator().manual_seed(seed)
    U = tbru.init_u0(N, dt, device="cpu") \
        + 0.1 * torch.randn((N, N, 2), generator=gen, dtype=dt)
    T = torch.randn((N, N, 2), generator=gen, dtype=dt)
    return U.to(device), T.to(device), _p(N, dt).to(device)


def _p(N, dtype):
    """``brusselator.default_p``'s (A, B, alpha, dx), with dx = 1 at N=1."""
    return torch.tensor([3.4, 1.0, 10.0, 1.0 / max(N - 1, 1)], dtype=dtype)


def _close(got, ref, dtype):
    got, ref = got.double().cpu(), ref.double().cpu()
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) <= RTOL[dtype] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N", [16, 33, 512])
def test_kernels_match_plain_on_card(cuda, N, dtype):
    U, T, p = _inputs(N, dtype, N, cuda)
    launches = dict(_backend.LAUNCHES)
    _close(tst.brusselator_jvp(U, T, p), tst.brusselator_jvp_plain(U, T, p),
           dtype)
    out, m = tst.brusselator_jvp_scaled(U, T, p, 0.5)
    ref, m_r = tst.brusselator_jvp_scaled_plain(U, T, p, 0.5)
    _close(out, ref, dtype)
    np.testing.assert_allclose(float(m), float(m_r), rtol=MAX_RTOL[dtype])
    planes = [U[..., 0].contiguous(), U[..., 1].contiguous(),
              T[..., 0].contiguous(), T[..., 1].contiguous()]
    ou, ov, m2 = tst.brusselator_jvp_scaled_pair(*planes, p, 0.5)
    _close(torch.stack([ou, ov], -1), ref, dtype)
    assert float(m2) == float(m)
    assert _backend.LAUNCHES["brusselator_jvp"] == \
        launches["brusselator_jvp"] + 1
    assert _backend.LAUNCHES["brusselator_jvp_scaled"] == \
        launches["brusselator_jvp_scaled"] + 2


@pytest.mark.cuda
def test_scaled_absmax_nan_on_card(cuda):
    U, T, p = _inputs(64, "float32", 2, cuda)
    T[5, 9, 0] = float("nan")
    _, m = tst.brusselator_jvp_scaled(U, T, p, 0.5)
    assert torch.isnan(m)


@pytest.mark.cuda
def test_inv_scale_tensor_on_card(cuda):
    U, T, p = _inputs(32, "float64", 3, cuda)
    inv = torch.tensor(0.125, dtype=torch.float64, device=cuda)
    out, m = tst.brusselator_jvp_scaled(U, T, p, inv)
    ref, m_r = tst.brusselator_jvp_scaled_plain(U, T, p, 0.125)
    _close(out, ref, "float64")
    np.testing.assert_allclose(float(m), float(m_r), rtol=1e-12)


K2_NS = [1, 2, 3, 37, 512, 513, 2048]
_BITS = {torch.bfloat16: torch.int16, torch.float32: torch.int32,
         torch.float64: torch.int64}


def _bit_equal(a, b):
    """Equal bit for bit (so -0 is not +0); a NaN matches any NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        a.view(_BITS[a.dtype])[~na], b.view(_BITS[b.dtype])[~nb]))


def _k2_call(layout, U, T, p, inv, plain=False):
    """K2, or its plain version, in either layout: (out (N, N, 2), max)."""
    if layout == "interleaved":
        fn = (tst.brusselator_jvp_scaled_plain if plain
              else tst.brusselator_jvp_scaled)
        return fn(U, T, p, inv)
    fn = (tst.brusselator_jvp_scaled_pair_plain if plain
          else tst.brusselator_jvp_scaled_pair)
    planes = [x[..., k].contiguous() for x in (U, T) for k in (0, 1)]
    ou, ov, mx = fn(*planes, p, inv)
    return torch.stack([ou, ov], -1), mx


def _launches(fn):
    """The launches of one call of ``fn``: the nodes (kernels, memsets,
    copies) it puts in a CUDA graph, counted by ``cuGraphGetNodes``."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    count = ctypes.c_size_t(0)
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_size_t)]
    assert libcuda.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()),
                                  None, ctypes.byref(count)) == 0
    return count.value


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N", K2_NS)
def test_k2_matches_plain_and_its_own_max_on_card(cuda, N, dtype, layout):
    """K2 against its plain version at the tolerances above, from one row
    up to N=2048 (odd N: rows not 16-byte aligned); its max equals max|out|
    of its own output exactly; a Python-float and a tensor inv_scale give
    the same bits."""
    U, T, p = _inputs(N, dtype, 100 + N, cuda)
    out, mx = _k2_call(layout, U, T, p, 0.5)
    ref, mx_ref = _k2_call(layout, U, T, p, 0.5, plain=True)
    _close(out, ref, dtype)
    np.testing.assert_allclose(float(mx), float(mx_ref), rtol=MAX_RTOL[dtype])
    assert float(mx) == float(out.abs().max())
    inv_t = torch.tensor(0.5, dtype=TORCH_DT[dtype], device=cuda)
    out_t, mx_t = _k2_call(layout, U, T, p, inv_t)
    assert _bit_equal(out_t, out) and _bit_equal(mx_t, mx)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k2_graph_replays_on_card(cuda, dtype, layout):
    """Three K2 calls captured in one CUDA graph, replayed 120 times with
    a new inv_scale each time: every replay's max is max|out| of its own
    output (a launch keeps nothing for the next) and out is the plain
    version's."""
    U, T, p = _inputs(300, dtype, 7, cuda)
    inv = torch.tensor(1.0, dtype=TORCH_DT[dtype], device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _k2_call(layout, U, T, p, inv)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [_k2_call(layout, U, T, p, inv) for _ in range(3)]
    rng = np.random.default_rng(0)
    for k in range(120):
        s = float(rng.uniform(0.1, 4.0))
        inv.fill_(s)
        graph.replay()
        torch.cuda.synchronize()
        for out, mx in outs:
            assert float(mx) == float(out.abs().max()), (k, s)
        if k % 20 == 0:
            ref, mx_ref = _k2_call(layout, U, T, p, s, plain=True)
            _close(outs[0][0], ref, dtype)
            np.testing.assert_allclose(float(outs[0][1]), float(mx_ref),
                                       rtol=MAX_RTOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
def test_k2_graphs_replayed_side_by_side_on_card(cuda, layout):
    """Two K2 graphs, both captured on PyTorch's one capture stream (two
    tangents, a tensor inv_scale each), replayed at once on two streams
    100 times with new inv_scales: each max is max|out| of its own output,
    each out the plain version's (launches share no state)."""
    U, T, p = _inputs(512, "float32", 12, cuda)
    tangents = [T, torch.flip(T, (0,)).contiguous()]
    invs = [torch.tensor(1.0, device=cuda) for _ in tangents]
    graphs, outs = [], []
    for Tk, inv in zip(tangents, invs):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            _k2_call(layout, U, Tk, p, inv)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(_k2_call(layout, U, Tk, p, inv))
        graphs.append(graph)
    streams = [torch.cuda.Stream() for _ in graphs]
    rng = np.random.default_rng(1)
    for k in range(100):
        scales = [float(rng.uniform(0.1, 4.0)) for _ in graphs]
        for inv, sc in zip(invs, scales):
            inv.fill_(sc)
        torch.cuda.synchronize()
        for graph, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                graph.replay()
        torch.cuda.synchronize()
        for out, mx in outs:
            assert float(mx) == float(out.abs().max()), k
        if k % 25 == 0:
            for (out, mx), Tk, sc in zip(outs, tangents, scales):
                ref, mx_ref = _k2_call(layout, U, Tk, p, sc, plain=True)
                _close(out, ref, "float32")
                np.testing.assert_allclose(float(mx), float(mx_ref),
                                           rtol=MAX_RTOL["float32"])


@pytest.mark.cuda
def test_k2_on_many_streams_at_once_on_card(cuda):
    """K2 issued on 80 streams without waiting between them (more streams
    than any per-stream table would hold): every max is max|out| of its
    own output."""
    U, T, p = _inputs(64, "float32", 13, cuda)
    streams = [torch.cuda.Stream() for _ in range(80)]
    torch.cuda.synchronize()
    outs = []
    for k, st in enumerate(streams):
        with torch.cuda.stream(st):
            outs.append(tst.brusselator_jvp_scaled(U, T, p, 0.1 + 0.05 * k))
    torch.cuda.synchronize()
    for k, (out, mx) in enumerate(outs):
        assert float(mx) == float(out.abs().max()), k
        ref, mx_ref = tst.brusselator_jvp_scaled_plain(U, T, p, 0.1 + 0.05 * k)
        _close(out, ref, "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["interleaved", "planar"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k2_nan_tangent_reaches_the_max_on_card(cuda, dtype, layout):
    U, T, p = _inputs(513, dtype, 8, cuda)
    T[400, 17, 1] = float("nan")
    out, mx = _k2_call(layout, U, T, p, 0.5)
    assert torch.isnan(mx) and torch.isnan(out).any()


@pytest.mark.cuda
def test_k2_is_two_kernels_a_call_on_card(cuda):
    """Two launches a wrapper call, the one-thread kernel that zeroes the
    max and K2, for a Python-float and a tensor inv_scale (no fill for
    it), both layouts."""
    U, T, p = _inputs(512, "float32", 9, cuda)
    inv_t = torch.tensor(0.25, device=cuda)
    for layout in ("interleaved", "planar"):
        for inv in (0.25, inv_t):
            planes = [x[..., k].contiguous() for x in (U, T) for k in (0, 1)]
            if layout == "interleaved":
                n = _launches(
                    lambda: tst.brusselator_jvp_scaled(U, T, p, inv))
            else:
                n = _launches(
                    lambda: tst.brusselator_jvp_scaled_pair(*planes, p, inv))
            assert n == 2, (layout, inv)


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernel_does_not_take(cuda):
    U, T, p = _inputs(16, "float32", 1, cuda)
    with pytest.raises(TypeError):
        tst.brusselator_jvp(U, T.double(), p)
    with pytest.raises(ValueError):
        tst.brusselator_jvp(U, T.transpose(0, 1), p)
    with pytest.raises(ValueError):
        tst.brusselator_jvp(U, T.cpu(), p)
    with pytest.raises(TypeError):
        tst.brusselator_jvp(U, T, p.double())
    with pytest.raises(ValueError):
        tst.brusselator_jvp(U[:8], T[:8], p)


@pytest.mark.cuda
def test_solve_on_card_matches_cpu(cuda):
    """The f64 N=16 Newton–GMRES–FFT solve: kernel K1 on the card against
    the plain version on the CPU (same retcode and stats, u atol 1e-8)."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.ops.preconditioners import \
        fft_poisson_preconditioner

    N = 16
    alg = tnls.NewtonRaphson(linsolve=tnls.LinearSolver(
        method="gmres", restart=30,
        precond_fn=fft_poisson_preconditioner(
            (N, N), alpha=10.0, h=1.0 / (N - 1), shift=3.0,
            n_components=2)))
    sols = [tnls.solve(tbru.make_problem(N, kernel_jvp=True, device=d), alg,
                       abstol=1e-10) for d in (cuda, "cpu")]
    assert sols[0].retcode == sols[1].retcode == tnls.ReturnCode.Success
    assert sols[0].stats == sols[1].stats
    np.testing.assert_allclose(sols[0].u.cpu().numpy(), sols[1].u.numpy(),
                               rtol=0, atol=1e-8)


# ---------------------------------------------------------------------------
# K4 (dia_spmv) and K5 (gather_spmv, gather_select): exact selections; the
# products at rel-inf 1e-12 (f64) / 1e-5 (f32) of max|y| (FMA contraction
# and, for K5 against index_add_, the summation order)
# ---------------------------------------------------------------------------

def _bru_csr(N, dtype, seed, device):
    from nonlinearsolve_tpu_torch.models.brusselator import sparsity_pattern
    pat = sparsity_pattern(N)
    gen = torch.Generator().manual_seed(seed)
    data = torch.randn(pat.nnz, generator=gen, dtype=TORCH_DT[dtype])
    x = torch.randn(pat.shape[0], generator=gen, dtype=TORCH_DT[dtype])
    return pat.with_data(data.to(device)), x.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("N", [16, 512])
def test_spmv_kernels_match_plain_on_card(cuda, N, dtype):
    from nonlinearsolve_tpu_torch.ops import spmv
    A, x = _bru_csr(N, dtype, N, cuda)
    tier, plan = spmv.select_spmv_plan(A.indptr, A.indices, *A.shape)[:2]
    assert tier == "dia" and plan.ndiag == 11
    launches = dict(_backend.LAUNCHES)
    src = plan.sel.table(cuda)
    dd = spmv.gather_select(src, A.data)
    assert torch.equal(dd, spmv.gather_select_plain(src, A.data))
    dd = dd.reshape(plan.ndiag, -1)
    _close(spmv.dia_spmv(dd, plan.offsets, x),
           spmv.dia_spmv_plain(dd, plan.offsets, x), dtype)
    indptr, indices = A.device_tables(cuda)
    _close(spmv.gather_spmv(indptr, indices, A.data, x),
           spmv.gather_spmv_plain(indptr, indices, A.data, x), dtype)
    for name in ("gather_select", "dia_spmv", "gather_spmv"):
        assert _backend.LAUNCHES[name] == launches[name] + 1


@pytest.mark.cuda
def test_dia_spmv_pad_slots_are_not_read_on_card(cuda):
    from nonlinearsolve_tpu_torch.ops import spmv
    n, offsets = 4096, (-1024, -1, 0, 2, 1024)
    gen = torch.Generator().manual_seed(5)
    dd = torch.randn((len(offsets), n), generator=gen, dtype=torch.float64)
    x = torch.randn(n, generator=gen, dtype=torch.float64)
    clean = dd.clone()
    for d, off in enumerate(offsets):
        if off > 0:
            dd[d, n - off:] = float("inf")
            clean[d, n - off:] = 0.0
        elif off < 0:
            dd[d, :-off] = float("nan")
            clean[d, :-off] = 0.0
    y = spmv.dia_spmv(dd.to(cuda), offsets, x.to(cuda))
    assert bool(torch.isfinite(y).all())
    _close(y, spmv.dia_spmv_plain(clean, offsets, x), "float64")


@pytest.mark.cuda
def test_gather_spmv_on_an_unstructured_pattern_on_card(cuda):
    from nonlinearsolve_tpu_torch.ops import spmv
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    rng = np.random.default_rng(3)
    n, m = 5000, 4000
    counts = rng.integers(0, 13, size=n)
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, m, size=rows.size)
    A = CSR.from_pattern(rows, cols, (n, m),
                         data=torch.tensor(rng.standard_normal(rows.size)))
    A = A.with_data(A.data.to(cuda))
    x = torch.tensor(rng.standard_normal(m), device=cuda)
    # the JAX package's resident tier, which the port runs on K5
    assert spmv.select_spmv_plan(A.indptr, A.indices, n, m)[0] == "resident"
    indptr, indices = A.device_tables(cuda)
    _close(A.matvec(x), spmv.gather_spmv_plain(indptr, indices, A.data, x),
           "float64")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_gather_spmv_edges_on_card(cuda, dtype):
    """K5 on 1001 rows (not a whole number of blocks), 200 of them empty
    and one of 5000 entries (longer than a block's staging chunk), and
    rows of 7 scattered columns: at TOL of its plain version, and two
    launches bit-equal."""
    from nonlinearsolve_tpu_torch.ops import spmv
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    rng = np.random.default_rng(13)
    n, m = 1001, 60000
    counts = np.full(n, 7)
    counts[300:500] = 0
    counts[777] = 5000
    rows = np.repeat(np.arange(n), counts)
    cols = rng.integers(0, m, size=rows.size)
    A = CSR.from_pattern(rows, cols, (n, m))
    assert np.diff(A.indptr)[777] > 2048
    assert np.diff(A.indptr)[300:500].max() == 0
    gen = torch.Generator().manual_seed(13)
    data = torch.randn(A.nnz, generator=gen, dtype=TORCH_DT[dtype]).to(cuda)
    x = torch.randn(m, generator=gen, dtype=TORCH_DT[dtype]).to(cuda)
    indptr, indices = A.device_tables(cuda)
    launches = dict(_backend.LAUNCHES)
    y = spmv.gather_spmv(indptr, indices, data, x)
    assert torch.equal(spmv.gather_spmv(indptr, indices, data, x), y)
    assert _backend.LAUNCHES["gather_spmv"] == launches["gather_spmv"] + 2
    assert not bool(y[300:500].any())
    _close(y, spmv.gather_spmv_plain(indptr, indices, data, x), dtype)


@pytest.mark.cuda
def test_spmv_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from nonlinearsolve_tpu_torch.ops import spmv
    x = torch.ones(8, dtype=torch.float64, device=cuda)
    dd = torch.ones((2, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        spmv.dia_spmv(dd.float(), (0, 1), x)
    with pytest.raises(ValueError):
        spmv.dia_spmv(dd, (0, 1, 2), x)
    with pytest.raises(ValueError):
        spmv.dia_spmv(torch.ones((49, 8), dtype=torch.float64, device=cuda),
                      tuple(range(49)), x)
    with pytest.raises(ValueError):
        spmv.gather_select(torch.zeros(3, dtype=torch.int32), x)
    with pytest.raises(TypeError):
        spmv.gather_select(torch.zeros(3, dtype=torch.int64, device=cuda), x)


@pytest.mark.cuda
def test_sparse_solve_on_card_matches_cpu(cuda):
    """The flat f64 N=16 sparse path (DIA route): K5's selection once per
    Jacobian and K4 in every product on the card, the plain versions on
    the CPU; the same retcode and stats, u atol 1e-9."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.ops.preconditioners import \
        fft_poisson_preconditioner

    N = 16

    def flat(u, p):
        return tbru.brusselator_2d(u.reshape(N, N, 2), p).reshape(-1)

    alg = tnls.NewtonRaphson(
        autodiff=tnls.JacobianPolicy(mode="sparse"),
        linsolve=tnls.LinearSolver(
            method="gmres", restart=8, krylov_maxiter=100,
            precond_fn=fft_poisson_preconditioner(
                (N, N), alpha=10.0, h=1.0 / (N - 1), shift=3.0,
                n_components=2)),
        forcing=tnls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    f = tnls.NonlinearFunction(f=flat, sparsity=tbru.sparsity_pattern(N))
    sols = []
    for d in (cuda, "cpu"):
        prob = tnls.NonlinearProblem(
            f, tbru.init_u0(N, device=d).reshape(-1),
            tbru.default_p(N, device=d))
        _backend.reset_counters()
        sols.append((tnls.solve(prob, alg, abstol=1e-8, maxiters=30),
                     dict(_backend.LAUNCHES)))
    (gpu, lg), (cpu, lc) = sols
    assert gpu.retcode == cpu.retcode == tnls.ReturnCode.Success
    assert gpu.stats == cpu.stats
    np.testing.assert_allclose(gpu.u.cpu().numpy(), cpu.u.numpy(), rtol=0,
                               atol=1e-9)
    assert lg["gather_select"] == gpu.stats.njacs
    assert lg["dia_spmv"] == gpu.counters["jvp"] > 0
    assert lg["gather_spmv"] == lg["brusselator_jvp"] == 0
    assert not any(lc.values())


# ---------------------------------------------------------------------------
# K7 (band_spmv): rel-inf 1e-12 (f64) / 1e-5 (f32) of max|y| against its
# plain version on the card; K8 (scatter_spmv_part): bit for bit against
# its sequential reference
# ---------------------------------------------------------------------------

def _periodic7(N, perm=None):
    """The 3D periodic 7-point pattern (CSR, columns sorted), optionally
    with its unknowns renumbered by ``perm``."""
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    n = N ** 3
    i = np.arange(n)
    x, y, z = i // (N * N), (i // N) % N, i % N

    def idx(a, b, c):
        return ((a % N) * N + (b % N)) * N + (c % N)
    cols = np.stack([idx(x - 1, y, z), idx(x, y - 1, z), idx(x, y, z - 1), i,
                     idx(x, y, z + 1), idx(x, y + 1, z), idx(x + 1, y, z)], 1)
    rows = np.repeat(i, 7)
    cols = cols.reshape(-1)
    if perm is not None:
        pinv = np.argsort(perm)
        rows, cols = pinv[rows], pinv[cols]
    return CSR.from_pattern(rows, cols, (n, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_band_spmv_matches_plain_on_card(cuda, dtype):
    from nonlinearsolve_tpu_torch.ops import spmv_stream as tst
    pat = _periodic7(40)          # the 256³ band structure: 11 slots
    plan = tst.BandPlan(pat.indptr, pat.indices, *pat.shape)
    assert plan.ok and (plan.w, len(plan.bands)) == (11, 5)
    gen = torch.Generator().manual_seed(11)
    data = torch.randn(pat.nnz, generator=gen, dtype=TORCH_DT[dtype])
    x = torch.randn(pat.shape[1], generator=gen, dtype=TORCH_DT[dtype])
    data, x = data.to(cuda), x.to(cuda)
    launches = dict(_backend.LAUNCHES)
    packed = plan.pack_data(data)
    cols = plan.cols_table(cuda)
    y = tst.band_spmv_packed(cols, packed, x, pat.shape[0])
    _close(y, tst.band_spmv_plain(cols, packed, x, pat.shape[0]), dtype)
    indptr, indices = pat.device_tables(cuda)
    from nonlinearsolve_tpu_torch.ops import spmv
    _close(y, spmv.gather_spmv_plain(indptr, indices, data, x), dtype)
    # inf in every pad slot: never read, y bit-equal
    packed_inf = packed.clone()
    packed_inf[cols < 0] = float("inf")
    y_inf = tst.band_spmv_packed(cols, packed_inf, x, pat.shape[0])
    assert torch.equal(y_inf, y)
    assert _backend.LAUNCHES["band_spmv"] == launches["band_spmv"] + 2
    assert _backend.LAUNCHES["gather_select"] == \
        launches["gather_select"] + 1


def _scatter_case(name, monkeypatch):
    """A CSR pattern and its scatter plan: ``parts`` (dense rows, a chained
    R of depth 2, column parts with the x cap lowered), ``depth3`` (a row
    of 1100 positions: R chained twice), ``big-zone`` (rows of 100: zones
    of 12,800 positions, past K8's 48 KB product buffer in f32 and f64)."""
    from nonlinearsolve_tpu_torch.ops import spmv, spmv_scatter as tsc
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    rng = np.random.default_rng(4)
    if name == "parts":
        monkeypatch.setattr(spmv, "MAX_X_ELEMS_VMEM", 2048)
        shape = (512, 4096)
        rows = np.concatenate([np.repeat(np.arange(512), 3),
                               np.repeat(np.arange(4), 100)])
        cols = rng.integers(0, 4096, size=rows.size)
    elif name == "depth3":
        shape = (600, 3000)
        rows = np.concatenate([np.repeat(np.arange(600), 7),
                               np.full(1100, 300)])
        cols = np.concatenate([rng.integers(0, 3000, size=4200),
                               rng.choice(3000, 1100, replace=False)])
    else:
        shape = (256, 20000)
        rows = np.repeat(np.arange(256), 100)
        cols = rng.integers(0, 20000, size=rows.size)
    A = CSR.from_pattern(rows, cols, shape)
    plan = tsc.ScatterPlan(A.indptr, A.indices, *A.shape)
    assert plan.ok
    depth = max(len(p.r_plans) for (*_, p) in plan.parts)
    if name == "parts":
        assert len(plan.parts) >= 2 and depth == 2
    elif name == "depth3":
        assert depth == 3
    else:
        assert max(int(np.diff(p.zstart).max())
                   for (*_, p) in plan.parts) * 4 > 48 * 1024
    return A, plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", ["parts", "depth3", "big-zone"])
def test_scatter_kernels_match_plain_on_card(cuda, name, dtype, monkeypatch):
    """K8, one launch a part, bit-equal to the sequential reference (the
    plain products, each R level summed slot by slot, the parts added in
    order), and at TOL of K5's plain version of A·x."""
    from nonlinearsolve_tpu_torch.ops import spmv, spmv_scatter as tsc
    A, plan = _scatter_case(name, monkeypatch)
    gen = torch.Generator().manual_seed(12)
    data = torch.randn(A.nnz, generator=gen, dtype=TORCH_DT[dtype]).to(cuda)
    x = torch.randn(A.shape[1], generator=gen,
                    dtype=TORCH_DT[dtype]).to(cuda)
    staged = plan.stage(data)
    launches = dict(_backend.LAUNCHES)
    y = y_ref = None
    for t, gdata in zip(plan.tables(cuda), staged):
        y = tsc.scatter_spmv_part(t, gdata, x, y)
        y_ref = tsc.scatter_part_sequential(t, gdata, x, y_ref)
    assert torch.equal(y, y_ref)
    assert torch.equal(tsc.scatter_spmv(plan, data, x), y)
    indptr, indices = A.device_tables(cuda)
    _close(y, spmv.gather_spmv_plain(indptr, indices, data, x), dtype)
    assert _backend.LAUNCHES["scatter_spmv_part"] == \
        launches["scatter_spmv_part"] + 2 * len(plan.parts)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["stream", "scatter"])
def test_band_and_scatter_route_solves_on_card_match_cpu(cuda, route,
                                                        monkeypatch):
    """The 3D sparse path, f64: the band route at 16³ (the DIA and x caps
    lowered so that the stream tier takes the pattern, as at 256³) and the
    scatter route at 20³ permuted.  K7 (or K8) in every product and K5's
    selection twice a Jacobian on the card, the plain versions on the CPU;
    the same retcode and stats, u atol 1e-9."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.core import solve as tsolve
    from nonlinearsolve_tpu_torch.models import reaction_diffusion as trd
    from nonlinearsolve_tpu_torch.ops import spmv, spmv_dia
    from nonlinearsolve_tpu_torch.ops.preconditioners import \
        fft_poisson_preconditioner

    spmv.clear_plan_caches()
    if route == "stream":
        N, perm = 16, None
        monkeypatch.setattr(spmv_dia, "DIA_MAX_TABLE", 50_000)
        monkeypatch.setattr(spmv, "MAX_X_ELEMS_VMEM", 2048)
    else:
        N = 20
        perm = np.random.default_rng(42).permutation(N ** 3)
    pinv = None if perm is None else np.argsort(perm)
    pat = _periodic7(N, perm)

    def flat(u, p):
        w = u if pinv is None else u[torch.as_tensor(pinv, device=u.device)]
        r = trd.reaction_diffusion_3d(w.reshape(N, N, N), p).reshape(-1)
        return r if perm is None else r[torch.as_tensor(perm,
                                                        device=u.device)]

    f = tnls.NonlinearFunction(f=flat, sparsity=pat)
    sols = []
    for d in (cuda, "cpu"):
        M0 = fft_poisson_preconditioner((N, N, N), 0.01, 1.0 / N,
                                        shift=-0.9)
        if perm is None:
            M = M0
        else:
            tp = torch.as_tensor(perm, device=d)
            tpi = torch.as_tensor(pinv, device=d)
            M = (lambda v, M0=M0, tp=tp, tpi=tpi: M0(v[tpi])[tp])
        alg = tnls.NewtonRaphson(
            autodiff=tnls.JacobianPolicy(mode="sparse"),
            linsolve=tnls.LinearSolver(method="gmres", restart=8,
                                       krylov_maxiter=200, precond_fn=M),
            forcing=tnls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
        u0 = torch.full((N ** 3,), 0.1, dtype=torch.float64, device=d)
        p = (torch.tensor(0.01, dtype=torch.float64, device=d),
             trd.forcing(N, device=d))
        prob = tnls.NonlinearProblem(f, u0, p)
        _backend.reset_counters()
        sols.append((tnls.solve(prob, alg, abstol=1e-8, maxiters=30),
                     dict(_backend.LAUNCHES)))
    spmv.clear_plan_caches()
    (gpu, lg), (cpu, lc) = sols
    assert gpu.retcode == cpu.retcode == tnls.ReturnCode.Success
    assert gpu.stats == cpu.stats
    np.testing.assert_allclose(gpu.u.cpu().numpy(), cpu.u.numpy(), rtol=0,
                               atol=1e-9)
    plan, = tsolve._SPARSE_PLANS[f].values()
    tier, splan = plan.pattern.tier[:2]
    assert tier == route
    products = gpu.counters["jvp"]
    assert lg["gather_select"] == 2 * gpu.stats.njacs > 0
    if route == "stream":
        assert lg["band_spmv"] == products > 0
    else:
        assert lg["scatter_spmv_part"] == len(splan.parts) * products > 0
    assert lg["dia_spmv"] == lg["gather_spmv"] == 0
    assert not any(lc.values())


@pytest.mark.cuda
def test_band_and_scatter_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from nonlinearsolve_tpu_torch.ops import spmv_scatter as tsc
    from nonlinearsolve_tpu_torch.ops import spmv_stream as tst
    x = torch.ones(8, dtype=torch.float64, device=cuda)
    cols = torch.zeros((2, 8), dtype=torch.int32, device=cuda)
    data = torch.ones((2, 8), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        tst.band_spmv_packed(cols, data.float(), x, 8)
    with pytest.raises(TypeError):
        tst.band_spmv_packed(cols.long(), data, x, 8)
    with pytest.raises(ValueError):
        tst.band_spmv_packed(cols, data, x, 9)
    with pytest.raises(ValueError):
        tst.band_spmv_packed(cols, data[:, :4], x, 4)
    i32 = torch.zeros(9, dtype=torch.int32, device=cuda)
    t = tsc.PartTables(0, 8, i32[:8], [(i32, i32[:8])], (0,), i32[:2], i32,
                       8, 8)
    tsc.scatter_spmv_part(t, x, x)
    with pytest.raises(ValueError):
        tsc.scatter_spmv_part(t._replace(gcol=i32[:8].cpu()), x, x)
    with pytest.raises(ValueError):
        tsc.scatter_spmv_part(t._replace(gcol=i32[:4]), x, x)
    with pytest.raises(TypeError):
        tsc.scatter_spmv_part(t._replace(rptr=i32.long()), x, x)
    with pytest.raises(ValueError):
        tsc.scatter_spmv_part(t._replace(c1=9), x, x)
    with pytest.raises(ValueError):
        tsc.scatter_spmv_part(t._replace(rows_per_zone=4), x, x)
    with pytest.raises(ValueError):
        tsc.scatter_spmv_part(t, x, x, y=x[:4])


# ---------------------------------------------------------------------------
# K9 (rd3d_jvp_blocked) and K10 (rd3d_jvp_scaled): rel-inf 1e-12 (f64) /
# 1e-5 (f32) of max|out| (FMA contraction); the absmax as K2's
# ---------------------------------------------------------------------------

def _rd3d_inputs(shape, dtype, seed, device):
    gen = torch.Generator().manual_seed(seed)
    dt = TORCH_DT[dtype]
    u = 0.1 + 0.5 * torch.randn(shape, generator=gen, dtype=dt)
    t = torch.randn(shape, generator=gen, dtype=dt)
    return u.to(device), t.to(device), torch.tensor(0.01, dtype=dt,
                                                    device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(64, 64, 64), (24, 40, 36)])
def test_rd3d_kernels_match_plain_on_card(cuda, shape, dtype):
    from nonlinearsolve_tpu_torch.ops import stencil3d as t3
    u, t, D = _rd3d_inputs(shape, dtype, 7, cuda)
    launches = dict(_backend.LAUNCHES)
    ref = t3.rd3d_jvp_blocked_plain(u, t, D)
    for bz in (4, 8):
        for db in (False, True):
            _close(t3.rd3d_jvp_blocked(u, t, D, bz=bz, double_buffer=db),
                   ref, dtype)
        # D as a Python number: D/h² formed in double, as the JAX wrapper
        _close(t3.rd3d_jvp_blocked(u, t, 0.01, bz=bz),
               t3.rd3d_jvp_blocked_plain(u, t, 0.01), dtype)
        out, m = t3.rd3d_jvp_scaled(u, t, D, 0.5, bz=bz)
        ref_s, m_r = t3.rd3d_jvp_scaled_plain(u, t, D, 0.5)
        _close(out, ref_s, dtype)
        assert m.dtype == u.dtype
        np.testing.assert_allclose(float(m), float(m_r),
                                   rtol=MAX_RTOL[dtype])
    assert _backend.LAUNCHES["rd3d_jvp"] == launches["rd3d_jvp"] + 6
    assert _backend.LAUNCHES["rd3d_jvp_scaled"] == \
        launches["rd3d_jvp_scaled"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_rd3d_scaled_absmax_nan_on_card(cuda, dtype):
    from nonlinearsolve_tpu_torch.ops import stencil3d as t3
    u, t, D = _rd3d_inputs((16, 24, 40), dtype, 8, cuda)
    t[9, 3, 33] = float("nan")
    inv = torch.tensor(0.5, dtype=TORCH_DT[dtype], device=cuda)
    _, m = t3.rd3d_jvp_scaled(u, t, D, inv, bz=4)
    assert torch.isnan(m)


@pytest.mark.cuda
def test_rd3d_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from nonlinearsolve_tpu_torch.ops import stencil3d as t3
    u, t, D = _rd3d_inputs((16, 16, 16), "float32", 9, cuda)
    with pytest.raises(ValueError, match="must divide"):
        t3.rd3d_jvp_blocked(u, t, D, bz=5)
    with pytest.raises(ValueError, match="must divide"):
        t3.rd3d_jvp_scaled(u, t, D, 1.0, bz=32)
    with pytest.raises(TypeError):
        t3.rd3d_jvp_blocked(u, t.double(), D, bz=4)
    with pytest.raises(TypeError):
        t3.rd3d_jvp_blocked(u.half(), t.half(), D, bz=4)
    with pytest.raises(ValueError):
        t3.rd3d_jvp_blocked(u, t.cpu(), D, bz=4)
    with pytest.raises(ValueError):
        t3.rd3d_jvp_blocked(u, t, D.cpu(), bz=4)
    with pytest.raises(ValueError):
        t3.rd3d_jvp_blocked(u, t.transpose(1, 2), D, bz=4)
    with pytest.raises(ValueError):
        t3.rd3d_jvp_blocked(u[:8], t, D, bz=4)
    with pytest.raises(ValueError):
        t3.rd3d_jvp_blocked(u[0], t[0], D, bz=1)
    with pytest.raises(ValueError):
        t3.rd3d_jvp_scaled(u, t, D, torch.ones(2, device=cuda), bz=4)


@pytest.mark.cuda
def test_rd3d_solve_on_card_matches_cpu(cuda):
    """The 64³ f64 solve at the example's algorithm (GMRES(8), shift −0.9,
    η = 0.1): K9 in every product on the card, the plain version on the
    CPU; the same retcode and stats, u within rel-inf 1e-8."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.models import reaction_diffusion as trd
    from nonlinearsolve_tpu_torch.ops.preconditioners import \
        fft_poisson_preconditioner

    N = 64
    alg = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(
            method="gmres", restart=8, krylov_maxiter=200,
            precond_fn=fft_poisson_preconditioner((N, N, N), 0.01, 1.0 / N,
                                                  shift=-0.9)),
        forcing=tnls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    sols = []
    for d in (cuda, "cpu"):
        _backend.reset_counters()
        sols.append((tnls.solve(trd.make_problem(N, kernel_jvp=True,
                                                 device=d),
                                alg, abstol=1e-5 * N, maxiters=30),
                     dict(_backend.LAUNCHES)))
    (gpu, lg), (cpu, lc) = sols
    assert gpu.retcode == cpu.retcode == tnls.ReturnCode.Success
    assert gpu.stats == cpu.stats
    scale = float(cpu.u.abs().max())
    assert float((gpu.u.cpu() - cpu.u).abs().max()) <= 1e-8 * scale
    assert lg["rd3d_jvp"] == gpu.counters["jvp"] > 0
    assert not any(lc.values())


@pytest.mark.cuda
@pytest.mark.parametrize("N", [16, 33, 512])
def test_k3_matches_plain_on_card_bit_for_bit(cuda, N):
    """K3 rounds every operation to bf16 in the plain version's order, with
    no FMA contraction: bit-equal to the plain version on the card."""
    U, T, p = _inputs(N, "float32", 40 + N, cuda)
    bf = torch.bfloat16
    Ub, Tb = U.to(bf), T.to(bf)
    launches = dict(_backend.LAUNCHES)
    got = tst.brusselator_jvp_bf16(Ub, Tb, p)
    ref = tst.brusselator_jvp_bf16_plain(Ub, Tb, p)
    assert got.dtype == bf and torch.equal(got, ref)
    mv = tst.make_brusselator_jvp_bf16(U, p)
    out = mv(T)
    assert out.dtype == torch.float32 and torch.equal(out, ref.float())
    assert _backend.LAUNCHES["brusselator_jvp_bf16"] == \
        launches["brusselator_jvp_bf16"] + 2
    assert _backend.LAUNCHES["brusselator_jvp"] == launches["brusselator_jvp"]


@pytest.mark.cuda
def test_k3_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    U, T, p = _inputs(16, "float32", 4, cuda)
    bf = torch.bfloat16
    with pytest.raises(TypeError):
        tst.brusselator_jvp_bf16(U, T, p)                 # f32 state
    with pytest.raises(TypeError):
        tst.brusselator_jvp_bf16(U.to(bf), T.to(bf), p.to(bf))
    with pytest.raises(ValueError):
        tst.brusselator_jvp_bf16(U.to(bf), T.to(bf).cpu(), p)
    with pytest.raises(ValueError):
        tst.brusselator_jvp_bf16(U.to(bf), T.to(bf).transpose(0, 1), p)


# ±0, values near the bf16 maximum (sums and products overflow to ±inf,
# and inf - inf gives NaN), bf16 subnormals, and mixed signs
EDGE_POOL = [0.0, -0.0, 3.3e38, -3.3e38, 1.7e38, -2.6e38, 1e-39, -1e-39,
             9.2e-41, -9.2e-41, 1.0, -1.0, 2.0, 0.5]


def _edge_inputs(N, seed, device, mode):
    """U, T (N, N, 2) f32 and p f32 from a seed (tests/
    test_torch_stencil_redesign.py's inputs): "edges" draws a fifth of the
    values from EDGE_POOL; "tiny" scales T by 1e-38 (bf16 subnormals) with a
    fifth ±0, and al = 1e-3."""
    rng = np.random.default_rng(seed)

    def one(scale, pool):
        x = rng.standard_normal((N, N, 2)) * scale
        mask = rng.random((N, N, 2)) < 0.2
        x[mask] = rng.choice(pool, int(mask.sum()))
        return torch.tensor(x, dtype=torch.float32, device=device)

    pool = EDGE_POOL if mode == "edges" else [0.0, -0.0]
    U = one(1.0, pool)
    T = one(1e-38 if mode == "tiny" else 10.0, pool)
    p = torch.tensor([3.4, 1.0, 1e-3 if mode == "tiny" else 10.0,
                      1.0 if mode == "tiny" else 1.0 / max(N - 1, 1)],
                     dtype=torch.float32, device=device)
    return U, T, p


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["seeded", "edges", "tiny"])
@pytest.mark.parametrize("N", K2_NS)
def test_k3_and_its_f32_variant_bit_equal_on_card(cuda, N, mode):
    """K3 (bf16x2 arithmetic) against its plain version, and the bf16
    matvec on an f32 tangent (one launch of K3's f32 variant) against
    cast -> K3's plain version -> cast, bit for bit (NaN for NaN), from
    one row up to N=2048, odd N included; with edge values and subnormal
    results too."""
    U, T, p = (_inputs(N, "float32", 50 + N, cuda) if mode == "seeded"
               else _edge_inputs(N, 50 + N, cuda, mode))
    bf = torch.bfloat16
    Ub, Tb = U.to(bf), T.to(bf)
    got = tst.brusselator_jvp_bf16(Ub, Tb, p)
    ref = tst.brusselator_jvp_bf16_plain(Ub, Tb, p)
    assert got.dtype == bf and _bit_equal(got, ref)
    mv = tst.make_brusselator_jvp_bf16(U, p)
    launches = dict(_backend.LAUNCHES)
    out = mv(T)
    assert _backend.LAUNCHES["brusselator_jvp_bf16"] == \
        launches["brusselator_jvp_bf16"] + 1
    ref32 = tst.brusselator_jvp_bf16_plain(Ub, T.to(bf), p).to(torch.float32)
    assert out.dtype == torch.float32 and _bit_equal(out, ref32)
    out_b = mv(Tb)
    assert out_b.dtype == bf and _bit_equal(out_b, ref)
    if mode == "edges" and N >= 37:
        assert not torch.isfinite(ref.float()).all()
    if mode == "tiny" and N >= 37:
        mag = ref.float().abs()
        assert ((mag > 0) & (mag < 1.1754944e-38)).any()


@pytest.mark.cuda
def test_bf16_matvec_is_one_kernel_for_an_f32_tangent_on_card(cuda):
    U, T, p = _inputs(512, "float32", 11, cuda)
    mv = tst.make_brusselator_jvp_bf16(U, p)
    Tb = T.to(torch.bfloat16)
    assert _launches(lambda: mv(T)) == 1
    assert _launches(lambda: mv(Tb)) == 1
    out64 = mv(T.double())
    assert out64.dtype == torch.float64
    assert torch.equal(out64, mv(T).double())


@pytest.mark.cuda
def test_bf16_flagship_runs_on_card_match_cpu(cuda):
    """The flagship's bf16 runs at N=32 f32 (bench.py's algorithm with the
    bf16 basis; run (b) with the K3 matvec): the card's retcode and nsteps
    are the CPU's; run (b) launches K3 for every product and K1 never."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.ops.preconditioners import \
        fft_poisson_preconditioner

    N = 32
    alg = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(
            method="gmres", restart=8, krylov_maxiter=100,
            krylov_basis_dtype="bf16",
            precond_fn=fft_poisson_preconditioner(
                (N, N), alpha=10.0, h=1.0 / (N - 1), shift=3.0,
                n_components=2)),
        forcing=tnls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    for run in ("a", "b"):
        sols = []
        for d in (cuda, "cpu"):
            prob = tbru.make_problem(N, torch.float32, kernel_jvp=True,
                                     device=d)
            if run == "b":
                prob = tnls.NonlinearProblem(tnls.NonlinearFunction(
                    f=tbru.brusselator_2d,
                    jvp=lambda v, U, p: tst.make_brusselator_jvp_bf16(U, p)(
                        v)), prob.u0, prob.p)
            _backend.reset_counters()
            sols.append((tnls.solve(prob, alg, abstol=5.0, maxiters=30),
                         dict(_backend.LAUNCHES)))
        (gpu, lg), (cpu, _) = sols
        assert gpu.retcode == cpu.retcode
        assert abs(gpu.stats.nsteps - cpu.stats.nsteps) <= 1
        if run == "b":
            assert lg["brusselator_jvp_bf16"] == gpu.counters["jvp"] > 0
            assert lg["brusselator_jvp"] == 0
        else:
            assert lg["brusselator_jvp"] == gpu.counters["jvp"] > 0
            assert lg["brusselator_jvp_bf16"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape,S,bz", [((64, 64, 64), 4, 8),
                                        ((40, 72, 100), 4, 5)])
def test_k11_shards_equal_k9_on_card(cuda, shape, S, bz, dtype):
    """K11 on S z-slabs, each given its neighbours' planes and h of the
    whole grid, is K9 on the whole grid bit for bit; each slab agrees with
    K11's plain version."""
    from nonlinearsolve_tpu_torch.ops import stencil3d as t3
    u, t, D = _rd3d_inputs(shape, dtype, 11, cuda)
    nz = shape[0] // S
    launches = dict(_backend.LAUNCHES)
    parts = []
    for s in range(S):
        z = slice(s * nz, (s + 1) * nz)
        lo = t[(s * nz - 1) % shape[0]][None].contiguous()
        hi = t[((s + 1) * nz) % shape[0]][None].contiguous()
        ul, tl = u[z].contiguous(), t[z].contiguous()
        out = t3.rd3d_jvp_blocked_halo(ul, tl, lo, hi, D, bz=bz,
                                       n_global=shape[0])
        _close(out, t3.rd3d_jvp_blocked_halo_plain(ul, tl, lo, hi, D,
                                                   shape[0]), dtype)
        parts.append(out)
    whole = t3.rd3d_jvp_blocked(u, t, D, bz=bz)
    assert torch.equal(torch.cat(parts), whole)
    assert _backend.LAUNCHES["rd3d_jvp_halo"] == \
        launches["rd3d_jvp_halo"] + S


@pytest.mark.cuda
def test_k11_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from nonlinearsolve_tpu_torch.ops import stencil3d as t3
    u, t, D = _rd3d_inputs((16, 16, 16), "float32", 12, cuda)
    lo, hi = t[-1:].contiguous(), t[:1].contiguous()
    with pytest.raises(ValueError, match="must divide local Nz"):
        t3.rd3d_jvp_blocked_halo(u, t, lo, hi, D, bz=5)
    with pytest.raises(ValueError):
        t3.rd3d_jvp_blocked_halo(u, t, t[-2:], hi, D, bz=4)
    with pytest.raises(TypeError):
        t3.rd3d_jvp_blocked_halo(u, t, lo.double(), hi, D, bz=4)
    with pytest.raises(ValueError):
        t3.rd3d_jvp_blocked_halo(u, t, lo, hi.cpu(), D, bz=4)


@pytest.mark.cuda
def test_distributed_layer_at_world_size_one_on_card(cuda):
    """NCCL at world size 1 on the card: the ring hands a shard its own
    planes (no P2P call), so both 3D factories are K9 on the whole grid,
    and the weak-scaling report runs K11 in its two chains."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Shard

    from nonlinearsolve_tpu_torch.ops import stencil3d as t3
    from nonlinearsolve_tpu_torch.parallel import (
        create_mesh, sharded_rd3d_jvp_factory,
        sharded_rd3d_jvp_pallas_factory)
    from nonlinearsolve_tpu_torch.parallel.scaling import weak_scaling_report

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = create_mesh()
        u, t, _ = _rd3d_inputs((32, 32, 32), "float32", 13, cuda)
        ud, td = (DTensor.from_local(a, mesh, [Shard(0)], run_check=False)
                  for a in (u, t))
        whole = t3.rd3d_jvp_blocked(u, t, 0.01, bz=8)
        k11 = sharded_rd3d_jvp_pallas_factory(mesh, 0.01, 32)(ud, td)
        assert torch.equal(k11.to_local(), whole)
        rolls = sharded_rd3d_jvp_factory(mesh, 0.01, 32)(ud, td)
        _close(rolls.to_local(), whole, "float32")
        _backend.reset_counters()
        rows = weak_scaling_report([1, 2], base_n=32, n_matvecs=3,
                                   use_pallas=True, bz=8)
        assert [k for k, _, _ in rows] == [1] and rows[0][1] > 0
        assert _backend.LAUNCHES["rd3d_jvp_halo"] == 2 * 3
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# K6 (bsr_spmm): rel-inf 1e-12 (f64) / 1e-5 (f32) of max|Y| against its plain
# version (the same products; the plain index_add_ sums by atomics in no
# fixed order); BSR.matvec on the card is K5 on the expanded pattern
# ---------------------------------------------------------------------------

def _bsr(nbr, nbc, b, dtype, seed, device, empty_row=None, long_row=None):
    """A seeded block-sparse matrix with explicit zeros inside its blocks,
    as the port's BSR on ``device``; block row ``long_row`` holds 70
    blocks (more than a team's 32 lanes)."""
    from nonlinearsolve_tpu_torch.ops.sparse import BSR, CSR
    rng = np.random.default_rng(seed)
    A = np.zeros((nbr * b, nbc * b))
    for i in range(nbr):
        if i == empty_row:
            continue
        count = 70 if i == long_row else int(rng.integers(1, 6))
        for j in rng.choice(nbc, size=count, replace=False):
            A[i * b:(i + 1) * b, j * b:(j + 1) * b] = \
                rng.standard_normal((b, b))
    A[rng.random(A.shape) < 0.2] = 0.0
    T = BSR.from_csr(CSR.from_dense(A.astype(np.dtype(dtype)), device=device),
                     b)
    return T, rng


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nrhs", [1, 2, 8, 31, 32, 33, 37, 64, 100])
@pytest.mark.parametrize("b", [1, 2, 3, 4, 5, 8])
def test_bsr_spmm_matches_plain_on_card(cuda, b, nrhs, dtype):
    """Every instantiated block size and the generic one (b = 5), at the
    column counts where the team, the 16-byte loads, the column slots and
    the passes change, with an empty block row and one of 70 blocks."""
    from nonlinearsolve_tpu_torch.ops import spmv
    A, rng = _bsr(300, 280, b, dtype, 7 * b + nrhs, cuda, empty_row=5,
                  long_row=9)
    X = torch.tensor(rng.standard_normal((A.shape[1], nrhs)),
                     dtype=TORCH_DT[dtype], device=cuda)
    launches = _backend.LAUNCHES["bsr_spmm"]
    Y = spmv.bsr_spmm(A, X)
    assert _backend.LAUNCHES["bsr_spmm"] == launches + 1
    assert Y.dtype == X.dtype and Y.shape == (A.shape[0], nrhs)
    _close(Y, spmv.bsr_spmm_plain(A, X), dtype)
    assert bool((Y[5 * b:6 * b] == 0).all())        # the empty block row


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nrhs", [8, 64])
def test_bsr_spmm_x_off_16_byte_alignment_on_card(cuda, nrhs, dtype):
    """An X one value past a 16-byte boundary (nrhs a multiple of 4) is
    read one column a load: its Y equals the aligned X's bit for bit (each
    output is the same FMA chain) and the plain version at RTOL."""
    from nonlinearsolve_tpu_torch.ops import spmv
    A, rng = _bsr(300, 280, 2, dtype, 11 + nrhs, cuda, empty_row=5,
                  long_row=9)
    X = torch.tensor(rng.standard_normal((A.shape[1], nrhs)),
                     dtype=TORCH_DT[dtype], device=cuda)
    Xm = torch.empty(X.numel() + 1, dtype=X.dtype, device=cuda)[1:].view(
        X.shape)
    Xm.copy_(X)
    item = X.element_size()
    assert spmv.bsr_spmm_plan(2, nrhs, item, X.data_ptr()).vec > 1
    assert spmv.bsr_spmm_plan(2, nrhs, item, Xm.data_ptr()).vec == 1
    Ym = spmv.bsr_spmm(A, Xm)
    assert torch.equal(Ym, spmv.bsr_spmm(A, X))
    _close(Ym, spmv.bsr_spmm_plain(A, X), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("b,nrhs", [(1, 1), (2, 8), (2, 37), (3, 33),
                                    (4, 100), (5, 31), (8, 64)])
def test_bsr_spmm_exact_products_equal_plain_bit_for_bit_on_card(
        cuda, b, nrhs, dtype):
    """Entries 0, ±1, ±2 and ±0.5 and an X of small integers: every product
    and every partial sum is exact, so Y equals the plain version bit for
    bit in any sum order.  Block rows 0-7 hold 60 blocks each, so at b = 8
    their thread block has more blocks than one chunk of the stage holds
    and stages them in chunks; block row 20 is empty."""
    from nonlinearsolve_tpu_torch.ops import spmv
    from nonlinearsolve_tpu_torch.ops.sparse import BSR
    rng = np.random.default_rng(b * 100 + nrhs)
    nbr = nbc = 200
    counts = rng.integers(1, 6, nbr)
    counts[:8] = 60
    counts[20] = 0
    indices = np.concatenate([np.sort(rng.choice(nbc, int(c), replace=False))
                              for c in counts]).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    values = np.array([0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.5])
    data = torch.tensor(rng.choice(values, (len(indices), b, b)),
                        dtype=TORCH_DT[dtype], device=cuda)
    A = BSR(data, indices, indptr, (nbr * b, nbc * b), b)
    X = torch.tensor(rng.integers(-8, 9, (nbc * b, nrhs)),
                     dtype=TORCH_DT[dtype], device=cuda)
    plan = spmv.bsr_spmm_plan(b, nrhs, X.element_size(), X.data_ptr())
    stage = spmv.bsr_stage_blocks(indptr, b, X.element_size(),
                                  plan.team_shift)
    rows = spmv.BSR_THREADS >> plan.team_shift
    if b == 8:
        assert indptr[min(rows, nbr)] > stage     # several chunks
    Y = spmv.bsr_spmm(A, X)
    assert torch.equal(Y, spmv.bsr_spmm_plain(A, X))
    assert bool((Y[20 * b:21 * b] == 0).all())


@pytest.mark.cuda
def test_bsr_spmm_nan_reaches_exactly_its_rows_on_card(cuda):
    from nonlinearsolve_tpu_torch.ops import spmv
    A, rng = _bsr(200, 200, 3, "float64", 4, cuda)
    X = torch.tensor(rng.standard_normal((600, 8)), device=cuda)
    X[3 * 17 + 1, 5] = float("nan")                  # block column 17
    hit = A.indices == 17
    rows = (np.repeat(A.block_row_ids[hit] * 3, 3)
            + np.tile(np.arange(3), int(hit.sum())))
    expect = torch.zeros((600, 8), dtype=torch.bool)
    expect[torch.as_tensor(rows), 5] = True
    assert torch.equal(torch.isnan(spmv.bsr_spmm(A, X)).cpu(), expect)


@pytest.mark.cuda
def test_bsr_spmm_edges_on_card(cuda):
    from nonlinearsolve_tpu_torch.ops import spmv
    A, rng = _bsr(40, 40, 2, "float64", 9, cuda)
    X = torch.tensor(rng.standard_normal((80, 4)), device=cuda)
    launches = _backend.LAUNCHES["bsr_spmm"]
    Y0 = spmv.bsr_spmm(A, X[:, :0].contiguous())
    assert Y0.shape == (80, 0)
    assert _backend.LAUNCHES["bsr_spmm"] == launches     # no launch
    with pytest.raises(TypeError):
        spmv.bsr_spmm(A, X.float())
    with pytest.raises(ValueError):
        spmv.bsr_spmm(A, X.t())
    with pytest.raises(ValueError):
        spmv.bsr_spmm(A, X.cpu())


@pytest.mark.cuda
def test_bsr_matvec_launches_gather_spmv_on_card(cuda):
    from nonlinearsolve_tpu_torch.ops import spmv
    A, rng = _bsr(300, 300, 2, "float64", 3, cuda, empty_row=7)
    x = torch.tensor(rng.standard_normal(600), device=cuda)
    launches = dict(_backend.LAUNCHES)
    y = A.matvec(x)
    assert _backend.LAUNCHES["gather_spmv"] == launches["gather_spmv"] + 1
    assert _backend.LAUNCHES["bsr_spmm"] == launches["bsr_spmm"]
    _close(y, spmv.bsr_spmm_plain(A, x[:, None].contiguous())[:, 0],
           "float64")
    cpu = A.with_data(A.data.cpu())
    _close(y, cpu.matvec(x.cpu()), "float64")


# ---------------------------------------------------------------------------
# the dense solver surface on the card (no kernel of its own: cuSOLVER,
# cuBLAS and tensor operations)
# ---------------------------------------------------------------------------

def _singular(n, device):
    gen = torch.Generator().manual_seed(n)
    A = torch.randn(n, n, generator=gen, dtype=torch.float64)
    A[:, 1] = 0.0
    return A.to(device), torch.ones(n, dtype=torch.float64, device=device)


def _non_spd(n, device):
    gen = torch.Generator().manual_seed(n + 1)
    A = torch.randn(n, n, generator=gen, dtype=torch.float64)
    A = A + A.T
    A[0, 0] = -abs(float(A[0, 0])) - n
    return A.to(device), torch.ones(n, dtype=torch.float64, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 64])
@pytest.mark.parametrize("method", ["lu", "cholesky", "qr"])
def test_solve_dense_singular_neither_raises_nor_syncs_on_card(cuda, n,
                                                               method):
    """Inside ``deferred_fallbacks()`` (the engine's way) a singular (and,
    for Cholesky, a non-SPD) system gives non-finite values, ok = False and
    a set flag — with no host sync (torch's sync debug mode raises on one)
    and no exception."""
    from nonlinearsolve_tpu_torch.ops import linear_solve as tls
    cfg = tls.LinearSolver(method=method)
    cases = [_singular(n, cuda)] + ([_non_spd(n, cuda)]
                                    if method == "cholesky" else [])
    for A, b in cases:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with tls.deferred_fallbacks() as flags:
                x, ok = tls.solve_dense(A, b, cfg)
                if method == "cholesky":
                    z, okz = tls.solve_spd(A, b)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert not bool(ok) and not bool(torch.isfinite(x).all())
        assert all(bool(f) for f in flags)
        if method == "cholesky":
            assert not bool(okz) and not bool(torch.isfinite(z).all())
        # the fallback, decided with its read, repairs it as on the CPU
        w, okw = tls.solve_dense(A, b, cfg)
        wc, okc = tls.solve_dense(A.cpu(), b.cpu(), cfg)
        assert bool(okw) and bool(okc)
        scale = max(float(wc.abs().max()), 1.0)
        assert float((w.cpu() - wc).abs().max()) <= 1e-10 * scale


@pytest.mark.cuda
def test_lstsq_rank_deficient_matches_cpu_on_card(cuda):
    from nonlinearsolve_tpu_torch.ops import linear_solve as tls
    A = torch.tensor([[1.0, 2.0], [2.0, 4.0], [3.0, 6.0]],
                     dtype=torch.float64)
    b = torch.tensor([1.0, 0.0, 2.0], dtype=torch.float64)
    want, _ = tls._lstsq(A, b)
    got, _ = tls._lstsq(A.to(cuda), b.to(cuda))
    assert float((got.cpu() - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


@pytest.mark.cuda
def test_gauss_jordan_card_route_matches_host_on_card(cuda):
    """The tensor-operation route on the card (a CUDA graph a shape)
    against the host helper on the CPU, rel-inf 1e-12: the same
    operations, but whether the card's ``addcmul`` fuses its multiply-add
    as the host's does is the kernel's own choice, so they may differ by
    ulps.  A second call replays the same graph on new data."""
    from nonlinearsolve_tpu_torch.ops import linear_solve as tls
    gen = torch.Generator().manual_seed(4)
    for n in (1, 4, 10, 32):
        for _ in range(2):
            A = torch.randn(n, n, generator=gen, dtype=torch.float64)
            b = torch.randn(n, 3, generator=gen, dtype=torch.float64)
            want = tls.gauss_jordan_solve(A, b)
            got = tls.gauss_jordan_solve(A.to(cuda), b.to(cuda)).cpu()
            err = float((got - want).abs().max() / want.abs().max())
            assert err <= 1e-12, (n, err)


# the slice's other rows of tests/test_23_problems.py CASES
OTHER_23_ROWS = {
    "TrustRegion-Fan": ({"radius_update_scheme": "fan"}, {11, 21}),
    "TrustRegion-NLsolve": ({"radius_update_scheme": "nlsolve"}, {21}),
    "TrustRegion-Bastin": ({"radius_update_scheme": "bastin"}, {21}),
    "TrustRegion-Hei": ({"radius_update_scheme": "hei"}, {21}),
    "TrustRegion-Yuan": ({"radius_update_scheme": "yuan"}, {8, 11, 21}),
    "LevenbergMarquardt-Geodesic01": ({"alpha_geodesic": 0.1}, {11, 21}),
    "LevenbergMarquardt-Cholesky": ({"linsolve": "cholesky"}, {11, 21}),
    "PseudoTransient": ({"alpha_initial": 10.0}, {1, 8, 11}),
    "NewtonRaphson-BackTracking": ({"linesearch": "backtracking"}, {21}),
    # chip_smoke.py phase 19 runs NewtonRaphson on the other 22 problems
    "NewtonRaphson-1": ({"only": 1}, {1}),
}


def _other_row_alg(row, kw):
    import nonlinearsolve_tpu_torch as nls
    if row.startswith("TrustRegion"):
        return nls.TrustRegion(**kw)
    if row.startswith("LevenbergMarquardt"):
        if kw.get("linsolve") == "cholesky":
            return nls.LevenbergMarquardt(
                linsolve=nls.LinearSolver(method="cholesky"))
        return nls.LevenbergMarquardt(**kw)
    if row == "PseudoTransient":
        return nls.PseudoTransient(**kw)
    if row == "NewtonRaphson-1":
        return nls.NewtonRaphson()
    return nls.NewtonRaphson(linesearch=nls.BackTracking())


@pytest.mark.cuda
@pytest.mark.parametrize("row", list(OTHER_23_ROWS))
def test_23_problem_rows_on_card(cuda, row):
    """The slice's CASES rows that chip_smoke.py phase 19 does not run
    (and NewtonRaphson's problem 1, which it leaves here): the port's
    broken set on the card equals the literal set of
    tests/test_23_problems.py (f64, maxiters 10000, ‖f(u*)‖∞ ≤ 1e-4)."""
    import nonlinearsolve_tpu_torch as nls
    from nonlinearsolve_tpu_torch.models.problems23 import PROBLEMS_23
    kw, expected = OTHER_23_ROWS[row]
    broken = set()
    for tp in PROBLEMS_23:
        if tp.index != kw.get("only", tp.index):
            continue
        sol = nls.solve(nls.NonlinearProblem(
            tp.f, torch.tensor(tp.start, dtype=torch.float64, device=cuda)),
            _other_row_alg(row, kw), maxiters=10000)
        if not float(tp.f(sol.u).abs().max()) <= 1e-4:
            broken.add(tp.index)
    assert broken == expected


@pytest.mark.cuda
@pytest.mark.parametrize("kind,name", [
    ("linesearch", n) for n in (
        "BackTracking", "LiFukushimaLineSearch",
        "RobustNonMonotoneLineSearch", "StaticLineSearch", "StrongWolfe",
        "HagerZhang", "MoreThuente")] + [
    ("trustregion", m) for m in (
        "simple", "nlsolve", "nocedalwright", "hei", "yuan", "fan",
        "bastin")])
def test_each_globalization_solves_on_card(cuda, kind, name):
    """NewtonRaphson with each line search, TrustRegion with each radius
    scheme, and GaussNewton / PseudoTransient solve the quickstart
    problem u² = 2 on the card to abstol 1e-10 (the CPU's results are in
    tests/test_torch_globalization.py)."""
    import nonlinearsolve_tpu_torch as nls
    alg = (nls.TrustRegion(radius_update_scheme=name)
           if kind == "trustregion"
           else nls.NewtonRaphson(linesearch=getattr(nls, name)()))
    prob = nls.NonlinearProblem(
        lambda u, p: u * u - p,
        torch.tensor([1.0, 1.0], dtype=torch.float64, device=cuda), 2.0)
    for a in (alg, nls.GaussNewton(),
              nls.PseudoTransient(alpha_initial=10.0)):
        sol = nls.solve(prob, a, abstol=1e-10)
        assert sol.retcode == nls.ReturnCode.Success
        assert float((sol.u - 2.0 ** 0.5).abs().max()) <= 1e-10


# --- the quasi-Newton, spectral and polyalgorithm engines -----------------

def _conformance_solvers(nls):
    """tests/test_tpu_conformance.py's ten configurations (the reference's
    GPU test): (name, algorithm, whether the residual is asserted)."""
    qr = nls.LinearSolver(method="qr")
    gmres = nls.LinearSolver(method="gmres")
    return [
        ("NewtonRaphson", nls.NewtonRaphson(), True),
        ("LM-QR", nls.LevenbergMarquardt(linsolve=qr), True),
        ("LM-GMRES", nls.LevenbergMarquardt(linsolve=gmres), True),
        ("PseudoTransient", nls.PseudoTransient(), False),
        ("Klement", nls.Klement(), False),
        ("Broyden-LiFukushima",
         nls.Broyden(linesearch=nls.LiFukushimaLineSearch()), True),
        ("LBroyden-LiFukushima",
         nls.LimitedMemoryBroyden(threshold=2,
                                  linesearch=nls.LiFukushimaLineSearch()),
         False),
        ("DFSane", nls.DFSane(), True),
        ("TrustRegion-QR", nls.TrustRegion(linsolve=qr), True),
        ("TrustRegion-GMRES",
         nls.TrustRegion(linsolve=gmres,
                         autodiff=nls.JacobianPolicy(mode="forward")), True),
    ]


CONFORMANCE = [c[0] for c in _conformance_solvers(
    __import__("nonlinearsolve_tpu_torch"))]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFORMANCE)
def test_conformance_configs_on_card(cuda, name):
    """The ten f32 configurations of tests/test_tpu_conformance.py on
    f(u) = A u + b (the reference's RandomState(0) fixture), abstol =
    reltol = 1e-5: a finite iterate and a known retcode, and ‖A u* + b‖ <
    1e-4 where that test asserts it."""
    import nonlinearsolve_tpu_torch as nls
    (_, alg, check), = [c for c in _conformance_solvers(nls)
                        if c[0] == name]
    rng = np.random.RandomState(0)
    A = torch.tensor(rng.rand(4, 4), dtype=torch.float32, device=cuda)
    u0 = torch.tensor(rng.rand(4), dtype=torch.float32, device=cuda)
    b = torch.tensor(rng.rand(4), dtype=torch.float32, device=cuda)
    sol = nls.solve(nls.NonlinearProblem(lambda u, p: A @ u + b, u0), alg,
                    abstol=1e-5, reltol=1e-5)
    assert bool(torch.isfinite(sol.u).all()), name
    assert int(sol.retcode) in {int(c) for c in nls.ReturnCode}
    if check:
        resid = float(torch.linalg.norm(A @ sol.u + b))
        assert resid < 1e-4, f"{name}: |Au*+b| = {resid:.2e}"


# tests/test_23_problems.py CASES rows of the quasi-Newton, spectral and
# polyalgorithm engines: (algorithm, the broken set, the problems that take
# 1000 steps or more in the JAX package).  chip_smoke.py phase 20 runs the
# other problems; these run here.
QN_23_ROWS = {
    "Broyden": ("Broyden", {}, {1, 5, 6, 11, 18}, {1, 6, 21}),
    "Broyden-TrueJacobian": ("Broyden", {"init_jacobian": "true_jacobian"},
                             {1, 5, 6, 8, 11, 21}, {5, 21}),
    "Broyden-BadBroyden": ("Broyden", {"update_rule": "bad_broyden"},
                           {1, 5, 9, 11, 18}, {11}),
    "Broyden-TrueJacobian-Bad": (
        "Broyden", {"init_jacobian": "true_jacobian",
                    "update_rule": "bad_broyden"}, {1, 5, 6, 8, 11}, {5, 11}),
    "Klement": ("Klement", {}, {1, 2, 4, 5, 6, 7, 11, 22},
                {4, 5, 6, 7, 8, 9, 11, 22}),
    "Klement-TrueJacDiagonal": (
        "Klement", {"init_jacobian": "true_jacobian_diagonal"},
        {2, 4, 5, 6, 11, 22}, {4, 6, 7, 8, 9, 11, 12, 22}),
    "DFSane": ("DFSane", {}, {1, 2, 3, 5, 21}, {1, 2, 3, 5, 6, 21}),
    "LimitedMemoryBroyden": ("LimitedMemoryBroyden", {}, {1, 5, 6, 11, 18},
                             {6, 21}),
    "DefaultPolyalgorithm": (None, {}, set(), {1, 4, 5, 6, 11, 21}),
    "Broyden-TrustRegion": ("BroydenTR", {}, {3, 5, 11, 21}, {1, 21}),
    "LimitedMemoryBroyden-thresh2": ("LimitedMemoryBroyden",
                                     {"threshold": 2},
                                     {1, 2, 4, 5, 6, 8, 9, 10, 11, 13, 14,
                                      18, 19, 23}, {21}),
}
# cases whose side of the CASES row a one-ulp move of the start flips in
# the JAX package's own runs: the two where the port's CPU run lands on
# the other side (tests/test_torch_23_qn.py BROKEN_KNIFE_EDGES), and
# Klement-TrueJacDiagonal #7 (|f| ≤ 1e-4 from the start, MaxIters at |f| >
# 1e-4 with x[0] one ulp up; the card's run ends at 4.2e-3).  Held to a
# finite residual only.
QN_23_KNIFE_EDGES = {("Klement", 7), ("Broyden-TrueJacobian", 21),
                     ("Klement-TrueJacDiagonal", 7)}
QN_23_LONG = [(row, i) for row, v in QN_23_ROWS.items() for i in sorted(v[3])]


def _qn_alg(nls, name, kw):
    if name is None:
        return None
    if name == "BroydenTR":
        return nls.QuasiNewtonAlgorithm(
            update_rule="good_broyden", structure="full",
            trustregion=nls.GenericTrustRegionScheme(), name="BroydenTR")
    return getattr(nls, name)(**kw)


@pytest.mark.cuda
@pytest.mark.parametrize("row,index", QN_23_LONG,
                         ids=[f"{r}-{i}" for r, i in QN_23_LONG])
def test_qn_23_problem_long_cases_on_card(cuda, row, index):
    """The cases of 1000 JAX steps or more of the quasi-Newton /
    polyalgorithm rows (f64, maxiters 10000, ‖f(u*)‖∞ ≤ 1e-4): each on
    its side of the CASES row of tests/test_23_problems.py."""
    import nonlinearsolve_tpu_torch as nls
    from nonlinearsolve_tpu_torch.models.problems23 import PROBLEMS_23
    name, kw, broken, _ = QN_23_ROWS[row]
    tp = PROBLEMS_23[index - 1]
    prob = nls.NonlinearProblem(
        tp.f, torch.tensor(tp.start, dtype=torch.float64, device=cuda))
    alg = _qn_alg(nls, name, kw)
    sol = (nls.solve(prob, maxiters=10000) if alg is None
           else nls.solve(prob, alg, maxiters=10000))
    resid = float(tp.f(sol.u).abs().max())
    if (row, index) in QN_23_KNIFE_EDGES:
        assert np.isfinite(resid)
        return
    assert (resid <= 1e-4) == (index not in broken), resid


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3])
def test_gauss_jordan_graph_vector_then_block_on_card(cuda, n):
    """A vector right-hand side and a one-column block give the augmented
    matrix the same shape: each keeps its own CUDA graph and its own
    output shape, in either order (the quasi-Newton true-Jacobian init
    solves J X = I after a vector solve of the same size)."""
    from nonlinearsolve_tpu_torch.ops import linear_solve as tls
    gen = torch.Generator().manual_seed(n)
    A = (torch.randn(n, n, generator=gen, dtype=torch.float64)
         + 3 * torch.eye(n, dtype=torch.float64)).to(cuda)
    b = torch.randn(n, generator=gen, dtype=torch.float64).to(cuda)
    for _ in range(2):
        x = tls.gauss_jordan_solve(A, b)
        X = tls.gauss_jordan_solve(A, b[:, None])
        assert x.shape == (n,) and X.shape == (n, 1)
        assert float((X[:, 0] - x).abs().max()) == 0.0
        Xi = tls.gauss_jordan_solve(A, torch.eye(n, dtype=torch.float64,
                                                 device=cuda))
        assert Xi.shape == (n, n)
        assert float((A @ Xi - torch.eye(n, dtype=torch.float64,
                                          device=cuda)).abs().max()) < 1e-12


# ---------------------------------------------------------------------------
# slice 12: the sparse direct route (direct_sparse.py, device_lu.py)
# ---------------------------------------------------------------------------

def _bratu_lu(N, dtype):
    """A DeviceLU plan of the Bratu pattern at N² and seeded Jacobian-like
    data (diagonal −4, off-diagonals 1, each scaled by U(0.9, 1.1))."""
    from nonlinearsolve_tpu_torch.models import bratu as tbratu
    from nonlinearsolve_tpu_torch.ops.device_lu import DeviceLU
    pat = tbratu.sparsity_pattern(N)
    lu = DeviceLU(pat.indptr, pat.indices, N * N, dtype=dtype)
    rng = np.random.default_rng(N)
    diag = pat.indices == pat.row_ids
    data = rng.uniform(0.9, 1.1, pat.nnz) * np.where(diag, -4.0, 1.0)
    return lu, data, rng.standard_normal(N * N)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k5_on_device_lu_stage_tables_on_card(cuda, dtype):
    """K5 on every gather table of the 64² Bratu plan (the ELL stages and
    the dense stages' pre-gathers), with the refreshed values, against its
    plain version."""
    from nonlinearsolve_tpu_torch.ops import spmv as tsp
    lu, data, _ = _bratu_lu(64, TORCH_DT[dtype])
    _Ud, Lst, Ust, ok = lu.refresh_host(data, device=cuda)
    assert ok
    tables = lu.tables(cuda)
    n = 64 * 64
    x = torch.randn(n, dtype=TORCH_DT[dtype],
                    generator=torch.Generator().manual_seed(1)).to(cuda)
    checked = 0
    for stages, vals, tabs in ((lu.Lstages, Lst, tables["L"]),
                               (lu.Ustages, Ust, tables["U"])):
        for stage, sv, (indptr, indices) in zip(stages, vals, tabs):
            v = sv if stage[0] == "ell" else sv[2]
            if indices.shape[0] == 0:
                continue
            before = _backend.LAUNCHES["gather_spmv"]
            got = tsp.gather_spmv(indptr, indices, v, x)
            assert _backend.LAUNCHES["gather_spmv"] == before + 1
            _close(got, tsp.gather_spmv_plain(indptr, indices, v, x), dtype)
            checked += 1
    assert checked == lu.stage_summary()["k5_launches_per_solve"] == 11


@pytest.mark.cuda
@pytest.mark.parametrize("N", [32, 64])
def test_device_lu_solve_on_card_matches_cpu(cuda, N):
    """DeviceLU.solve on the card against the port's CPU solve of the same
    refreshed state (f64, rel-inf 1e-12); K5 launched once a gather."""
    lu, data, b = _bratu_lu(N, torch.float64)
    x_cpu, ok_cpu = lu.solve(lu.refresh_host(data, device="cpu"),
                             torch.tensor(b))
    state = lu.refresh_host(data, device=cuda)
    before = _backend.LAUNCHES["gather_spmv"]
    x_gpu, ok_gpu = lu.solve(state, torch.tensor(b, device=cuda))
    assert ok_cpu and ok_gpu
    assert _backend.LAUNCHES["gather_spmv"] - before == \
        lu.stage_summary()["k5_launches_per_solve"]
    _close(x_gpu, x_cpu, "float64")


@pytest.mark.cuda
@pytest.mark.parametrize("route,N,ls", [
    ("bcr", 24, {}), ("host_lu", 72, {}), ("pcr", None, {}),
    ("device_lu", 32, {"method": "sparse_lu_device"})])
def test_sparse_direct_routes_on_card_match_cpu(cuda, route, N, ls):
    """Bratu (or SNES ex2 for PCR) with a sparse-AD Jacobian on each
    direct route, on the card and on the CPU: the same retcode and
    NLStats, roots within 1e-10."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.models import bratu as tbratu
    from nonlinearsolve_tpu_torch.models import snes_ex2 as tsnes
    alg = tnls.NewtonRaphson(autodiff=tnls.JacobianPolicy(mode="sparse"),
                             linsolve=tnls.LinearSolver(**ls))
    sols = {}
    for dev in ("cpu", cuda):
        prob = (tsnes.make_problem(128, sparse=True, device=dev)
                if N is None else tbratu.make_problem(N, device=dev))
        _backend.reset_counters()
        sols[str(dev)] = tnls.solve(prob, alg, abstol=1e-10)
        assert _backend.ROUTES[route] == sols[str(dev)].stats.nsolve
    cpu, gpu = sols["cpu"], sols[str(cuda)]
    assert cpu.retcode == gpu.retcode == tnls.ReturnCode.Success
    assert vars(cpu.stats) == vars(gpu.stats)
    assert float((gpu.u.cpu() - cpu.u).abs().max()) <= 1e-10


@pytest.mark.cuda
def test_two_sparse_lu_device_solves_in_a_row_on_card(cuda):
    """The plan cache serves a second solve on the pattern (the JAX
    package's second solve raises there); each runs K5 on its sweeps."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.models import bratu as tbratu
    from nonlinearsolve_tpu_torch.ops import device_lu as tdl
    alg = tnls.NewtonRaphson(autodiff=tnls.JacobianPolicy(mode="sparse"),
                             linsolve=tnls.LinearSolver(
                                 method="sparse_lu_device"))
    roots = []
    for _ in range(2):
        before = _backend.LAUNCHES["gather_spmv"]
        sol = tnls.solve(tbratu.make_problem(64, device=cuda), alg,
                         abstol=1e-10)
        assert sol.retcode == tnls.ReturnCode.Success
        assert _backend.LAUNCHES["gather_spmv"] > before
        roots.append(sol.u)
    assert torch.equal(roots[0], roots[1])


# ---------------------------------------------------------------------------
# the batched tier (the simple solvers, bracketing, ensembles)
# ---------------------------------------------------------------------------

def _nan_equal(a, b):
    a, b = a.cpu(), b.cpu()
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [4, 10, 32])
def test_batched_gauss_jordan_on_card_matches_cpu(cuda, n, dtype):
    """The batched Gauss–Jordan (a CUDA graph a (B, n) shape on the card)
    against the CPU's host helper on the same matrices: each row's rel-inf
    difference within n·eps·κ∞(A) (the forward-error bound of the two
    eliminations' rounding; the card's rounds apart from the host's, by
    up to about 6.5e-15 at n = 32, f64), NaN in the same rows (a zero
    pivot); and each row of the batch bit-equal to the same matrix solved
    alone on the card (B = 1: the same operations on one matrix).
    solve_dense_batched's ridge fallback takes the singular row on both."""
    from nonlinearsolve_tpu_torch.ops import linear_solve as ls
    dt = TORCH_DT[dtype]
    gen = torch.Generator().manual_seed(11 + n)
    A = torch.randn((64, n, n), generator=gen, dtype=dt)
    b = torch.randn((64, n), generator=gen, dtype=dt)
    A[3] = 0.0                            # a zero pivot: NaN
    x_cpu = ls.gauss_jordan_batched(A, b)
    bad = torch.isnan(x_cpu).any(-1)
    assert bad.tolist() == [i == 3 for i in range(64)]
    kappa = torch.linalg.cond(A[~bad].double(), p=float("inf"))
    bound = n * torch.finfo(dt).eps * kappa
    for _ in range(2):                    # capture, then replay
        x_gpu = ls.gauss_jordan_batched(A.to(cuda), b.to(cuda))
        assert x_gpu.device.type == "cuda"
        assert torch.equal(torch.isnan(x_gpu).any(-1).cpu(), bad)
        got, ref = x_gpu.cpu()[~bad].double(), x_cpu[~bad].double()
        rel = (got - ref).abs().amax(-1) / ref.abs().amax(-1)
        assert bool((rel <= bound).all()), float((rel / bound).max())
    for i in (0, 3, 63):
        alone = ls.gauss_jordan_batched(A[i:i + 1].to(cuda),
                                        b[i:i + 1].to(cuda))
        assert _nan_equal(alone[0], x_gpu[i]), i
    y_cpu, ok_cpu = ls.solve_dense_batched(A, b)
    y_gpu, ok_gpu = ls.solve_dense_batched(A.to(cuda), b.to(cuda))
    assert bool(ok_cpu.all()) and bool(ok_gpu.all())
    assert torch.equal(y_gpu[3].cpu(), y_cpu[3])    # the ridge: x = 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["SimpleNewtonRaphson", "SimpleBroyden",
                                  "SimpleTrustRegion"])
def test_simple_ensemble_stays_on_card(cuda, name):
    """A small ensemble on the simple tier with CUDA tensors: every field
    comes back on the card, and each row matches the CPU run (retcode and
    NLStats equal, roots within 1e-12)."""
    import nonlinearsolve_tpu_torch as tnls
    ps = torch.linspace(0.5, 10.0, 256, dtype=torch.float64)
    sols = {}
    for dev in ("cpu", cuda):
        prob = tnls.NonlinearProblem(lambda u, p: u * u - p,
                                     torch.ones(2, dtype=torch.float64,
                                                device=dev))
        sols[str(dev)] = tnls.solve_ensemble(prob, getattr(tnls, name)(),
                                             ps=ps.to(dev))
    cpu, gpu = sols["cpu"], sols[str(cuda)]
    for t in (gpu.u, gpu.resid, gpu.retcode, gpu.stats.nsteps):
        assert t.device.type == "cuda"
    assert torch.equal(gpu.retcode.cpu(), cpu.retcode)
    assert bool(gpu.success.all())
    for k in ("nf", "njacs", "nsolve", "nsteps"):
        assert torch.equal(getattr(gpu.stats, k).cpu(),
                           getattr(cpu.stats, k)), k
    assert float((gpu.u.cpu() - cpu.u).abs().max()) <= 1e-12 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Bisection", "Brent", "ITP", "ModAB"])
def test_bracketing_batch_stays_on_card(cuda, name):
    """A bracketing batch on CUDA tensors: the fields come back on the
    card, equal to the CPU run (retcode, nf, steps; u to 4 ulps); the
    gradient du/dp on the card against 1/(2√p)."""
    import nonlinearsolve_tpu_torch as tnls
    ps = torch.linspace(0.5, 10.0, 1000, dtype=torch.float64)
    sols = {}
    for dev in ("cpu", cuda):
        sols[str(dev)] = tnls.solve(tnls.IntervalNonlinearProblem(
            lambda u, p: u * u - p,
            (torch.tensor(0.1, dtype=torch.float64, device=dev), 5.0),
            ps.to(dev)), getattr(tnls, name)())
    cpu, gpu = sols["cpu"], sols[str(cuda)]
    assert gpu.u.device.type == gpu.retcode.device.type == "cuda"
    assert torch.equal(gpu.retcode.cpu(), cpu.retcode)
    assert torch.equal(gpu.stats.nf.cpu(), cpu.stats.nf)
    assert torch.equal(gpu.stats.nsteps.cpu(), cpu.stats.nsteps)
    ulps = (gpu.u.cpu().view(torch.int64) - cpu.u.view(torch.int64)).abs()
    assert int(ulps.max()) <= 4
    p = ps.to(cuda).requires_grad_(True)
    u = tnls.solve(tnls.IntervalNonlinearProblem(
        lambda u, q: u * u - q,
        (torch.tensor(0.1, dtype=torch.float64, device=cuda), 5.0), p),
        getattr(tnls, name)()).u
    g, = torch.autograd.grad(u.sum(), p)
    assert g.device.type == "cuda"
    torch.testing.assert_close(g.cpu(), 0.5 / ps.sqrt(), rtol=1e-8, atol=0)


def test_interval_problem_of_python_floats_needs_cuda(monkeypatch):
    """No tensor among the endpoints and p: the solve runs on the card, and
    raises when there is no CUDA (no CPU fallback)."""
    import nonlinearsolve_tpu_torch as tnls
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prob = tnls.IntervalNonlinearProblem(lambda u, p: u * u - p, (1.0, 2.0),
                                         2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnls.solve(prob)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnls.solve(prob, tnls.Bisection())


# ---------------------------------------------------------------------------
# the reverse rules of K5, K7 and K8, the grad refusals, and differentiating
# through solve on the card (ROADMAP A.28, A.18)
# ---------------------------------------------------------------------------

def _reverse_case(route, dtype, monkeypatch, device):
    """A CSR on the card whose tier is ``route``, seeded data and x."""
    from nonlinearsolve_tpu_torch.ops import spmv, spmv_dia
    spmv.clear_plan_caches()
    if route == "resident":
        pat = _periodic7(12, np.random.default_rng(3).permutation(12 ** 3))
        monkeypatch.setattr(spmv, "_SCATTER_TRY_THRESHOLD", 1e9)
    elif route == "stream":
        monkeypatch.setattr(spmv_dia, "DIA_MAX_TABLE", 50_000)
        monkeypatch.setattr(spmv, "MAX_X_ELEMS_VMEM", 2048)
        pat = _periodic7(16)
    elif route == "scatter":
        pat = _periodic7(20, np.random.default_rng(42).permutation(20 ** 3))
    else:
        from nonlinearsolve_tpu_torch.models.brusselator import \
            sparsity_pattern
        pat = sparsity_pattern(16)
    gen = torch.Generator().manual_seed(31)
    dt = TORCH_DT[dtype]
    data = torch.randn(pat.nnz, generator=gen, dtype=dt).to(device)
    x = torch.randn(pat.shape[1], generator=gen, dtype=dt).to(device)
    w = torch.randn(pat.shape[0], generator=gen, dtype=dt).to(device)
    return pat.with_data(data), x, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("route", ["resident", "stream", "scatter", "dia"])
def test_spmv_reverse_rules_on_card(cuda, route, dtype, monkeypatch):
    """A loss through ``CSR.matvec`` gets x̄ from the route's kernel on Aᵀ
    (its launch counter rises by the backward) and d̄ata = ȳ[row]·x[col]:
    d̄ata bit for bit and x̄ at RTOL against autograd through the plain CSR
    product."""
    from nonlinearsolve_tpu_torch.ops import spmv
    kernel = {"resident": "gather_spmv", "stream": "band_spmv",
              "scatter": "scatter_spmv_part", "dia": "dia_spmv"}[route]
    C, x, w = _reverse_case(route, dtype, monkeypatch, cuda)
    assert C.tier[0] == route
    data = C.data.clone().requires_grad_(True)
    xr = x.clone().requires_grad_(True)
    loss = (w * C.with_data(data).matvec(xr)).sum()
    before = _backend.LAUNCHES[kernel]
    gd, gx = torch.autograd.grad(loss, (data, xr))
    troute = spmv.csr_route(C)[0].transpose()[0]
    parts = len(troute.plan.parts) if route == "scatter" else 1
    assert _backend.LAUNCHES[kernel] == before + parts
    indptr, indices = C.device_tables(cuda)
    dp = C.data.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    gd_p, gx_p = torch.autograd.grad(
        (w * spmv.gather_spmv_plain(indptr, indices, dp, xp)).sum(),
        (dp, xp))
    assert torch.equal(gd, gd_p)
    _close(gx, gx_p, dtype)
    spmv.clear_plan_caches()


@pytest.mark.cuda
def test_spmv_second_derivative_on_card(cuda, monkeypatch):
    """x̄ runs through the same Function: a Hessian-vector product of
    Σ sin(A·x) on the band route, against the dense formula."""
    from nonlinearsolve_tpu_torch.ops import spmv
    C, x, v = _reverse_case("stream", "float64", monkeypatch, cuda)
    xr = x.clone().requires_grad_(True)
    g, = torch.autograd.grad(torch.sin(C.matvec(xr)).sum(), xr,
                             create_graph=True)
    hv, = torch.autograd.grad((g * v).sum(), xr)
    D = C.todense()
    ref = D.T @ (-torch.sin(D @ x) * (D @ v))
    _close(hv, ref, "float64")
    spmv.clear_plan_caches()


@pytest.mark.cuda
def test_kernel_grad_refusals_on_card(cuda):
    """Under grad, the wrappers of kernels without a reverse rule raise on
    the card and name the kernel; the bare K5, K7 and K8 point to
    ``csr_spmv``."""
    from nonlinearsolve_tpu_torch.ops import spmv
    from nonlinearsolve_tpu_torch.ops import stencil3d as t3
    U, T, p = _inputs(16, "float32", 1, cuda)
    Tg = T.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="K1 brusselator_jvp"):
        tst.brusselator_jvp(U, Tg, p)
    with pytest.raises(NotImplementedError, match="K2"):
        tst.brusselator_jvp_scaled(U, Tg, p, 0.5)
    with pytest.raises(NotImplementedError, match="K3"):
        tst.make_brusselator_jvp_bf16(U, p)(Tg)
    xg = torch.ones(64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K4 dia_spmv"):
        spmv.dia_spmv(torch.ones((3, 64), device=cuda), (-1, 0, 1), xg)
    with pytest.raises(NotImplementedError, match="K5 gather_spmv.*csr_spmv"):
        spmv.gather_spmv(torch.tensor([0, 1], dtype=torch.int32,
                                      device=cuda),
                         torch.tensor([0], dtype=torch.int32, device=cuda),
                         torch.ones(1, device=cuda), xg)
    with pytest.raises(NotImplementedError, match="K5 gather_select"):
        spmv.gather_select(torch.zeros(4, dtype=torch.int32, device=cuda),
                           xg)
    u3 = torch.rand((8, 8, 8), device=cuda)
    t3g = torch.ones((8, 8, 8), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="K9"):
        t3.rd3d_jvp_blocked(u3, t3g, 0.01, bz=4)
    with pytest.raises(NotImplementedError, match="K10"):
        t3.rd3d_jvp_scaled(u3, t3g, 0.01, 1.0, bz=4)
    with torch.no_grad():
        assert torch.isfinite(tst.brusselator_jvp(U, Tg, p)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["resident", "stream", "scatter"])
def test_forward_mode_tangents_refused_on_card(cuda, route, monkeypatch):
    """A forward-mode tangent through ``CSR.matvec`` on each SpMV route,
    and through K1, raises on the card rather than come back without its
    tangent (``forward_ad`` and ``torch.func.jvp`` alike)."""
    from torch.autograd import forward_ad as fwAD
    from nonlinearsolve_tpu_torch.ops import spmv
    C, x, _w = _reverse_case(route, "float64", monkeypatch, cuda)
    U, T, p = _inputs(16, "float32", 1, cuda)
    for f, arg in ((C.matvec, x),
                   (lambda t: tst.brusselator_jvp(U, t, p), T)):
        with fwAD.dual_level():
            with pytest.raises(NotImplementedError,
                               match="no forward-mode rule"):
                f(fwAD.make_dual(arg, torch.ones_like(arg)))
        with pytest.raises(NotImplementedError, match="no forward-mode rule"):
            torch.func.jvp(f, (arg,), (torch.ones_like(arg),))
    spmv.clear_plan_caches()


@pytest.mark.cuda
def test_gradient_through_solve_on_card_matches_cpu(cuda):
    """p̄ of ⟨w, u*⟩ on the dense Brusselator (N=8, f64) and u̇ by forward
    mode, on the card and on the CPU: rel 1e-10."""
    import nonlinearsolve_tpu_torch as tnls
    from torch.autograd import forward_ad as fwAD
    out = {}
    for d in (cuda, "cpu"):
        prob = tbru.make_problem(8, torch.float64, device=d)
        w = torch.linspace(-1.0, 1.0, prob.u0.numel(),
                           dtype=torch.float64).reshape(prob.u0.shape).to(d)
        p = prob.p.clone().requires_grad_(True)
        u = tnls.solve(prob.remake(p=p), tnls.NewtonRaphson(),
                       abstol=1e-10).u
        pbar, = torch.autograd.grad((w * u).sum(), p)
        with fwAD.dual_level():
            ud = tnls.solve(prob.remake(p=fwAD.make_dual(
                prob.p, torch.eye(4, dtype=torch.float64, device=d)[0])),
                tnls.NewtonRaphson(), abstol=1e-10).u
            wdot = float((w * fwAD.unpack_dual(ud).tangent).sum())
        out[str(d)] = (pbar.cpu(), wdot)
    (g_pbar, g_wdot), (c_pbar, c_wdot) = out[str(cuda)], out["cpu"]
    torch.testing.assert_close(g_pbar, c_pbar, rtol=1e-10, atol=0)
    assert abs(g_wdot - float(g_pbar[0])) <= 1e-10 * abs(g_wdot)
    assert abs(g_wdot - c_wdot) <= 1e-10 * abs(c_wdot)


@pytest.mark.cuda
def test_iterator_equals_solve_on_card(cuda):
    """init → step → solve on the card: the solve's retcode, stats and root
    bit for bit; a trace and a phase timer change no root."""
    import nonlinearsolve_tpu_torch as tnls
    prob = tbru.make_problem(16, torch.float64, device=cuda)
    alg = tnls.NewtonRaphson()
    ref = tnls.solve(prob, alg, abstol=1e-10)
    cache = tnls.init(prob, alg, abstol=1e-10)
    cache.step(2)
    sol = cache.solve()
    assert sol.retcode == ref.retcode == tnls.ReturnCode.Success
    assert sol.stats == ref.stats and torch.equal(sol.u, ref.u)
    traced = tnls.solve(prob, alg, abstol=1e-10, store_trace=True,
                        time_phases=True)
    assert torch.equal(traced.u, ref.u)
    assert traced.trace.n == ref.stats.nsteps and traced.timer["total"] > 0


def _bratu_h(u, p, lam):
    from nonlinearsolve_tpu_torch.models.bratu import bratu_2d
    return bratu_2d(u, lam * p)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["HomotopySweep", "ArcLengthContinuation"])
def test_continuation_on_card_matches_cpu(cuda, method):
    """The Bratu λ-continuation (N=8, λ from 0 to 6.5, abstol 1e-8, f64,
    NewtonRaphson inner) on the card and on the CPU: the retcode and the
    NLStats equal, the last λ within 1e-10, the roots within 1e-9 (the
    solves stop at |H|_inf ≤ 1e-8, and cuSOLVER and LAPACK round apart);
    p̄ of ⟨w, u*⟩ by the implicit-function rule within rel 1e-9."""
    import nonlinearsolve_tpu_torch as tnls
    out = {}
    for d in (cuda, "cpu"):
        p = torch.tensor(1.0, dtype=torch.float64,
                         device=d).requires_grad_(True)
        prob = tnls.HomotopyProblem(
            _bratu_h, torch.zeros((8, 8), dtype=torch.float64, device=d), p,
            lambdaspan=(0.0, 6.5))
        sol = tnls.solve(prob, getattr(tnls, method)(
            inner=tnls.NewtonRaphson()), abstol=1e-8)
        assert sol.u.device.type == torch.device(d).type
        w = torch.linspace(0.5, 1.5, 64, dtype=torch.float64,
                           device=d).reshape(8, 8)
        pbar, = torch.autograd.grad((w * sol.u).sum(), p)
        out[str(d)] = sol, float(pbar)
    (g, g_pbar), (c, c_pbar) = out[str(cuda)], out["cpu"]
    assert g.retcode == c.retcode == tnls.ReturnCode.Success
    assert g.stats == c.stats
    assert abs(float(g.original) - float(c.original)) <= 1e-10
    torch.testing.assert_close(g.u.detach().cpu(), c.u.detach(), rtol=0,
                               atol=1e-9)
    assert abs(g_pbar - c_pbar) <= 1e-9 * abs(c_pbar)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["rosenbrock23", "tsit5"])
def test_dynamic_ss_on_card_matches_cpu(cuda, method):
    """DynamicSS on the logistic flow and on Bratu 8² (λ = 3.5), f64, on
    the card and on the CPU: the retcode and NLStats equal, the steady
    states within 1e-8 (each stops when |du/dt|_inf ≤ 1e-8)."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.models.bratu import bratu_2d
    for f, u0, p in ((lambda u, q: u * (q - u), [0.1, 0.5], 1.0),
                     (bratu_2d, np.zeros((8, 8)), 3.5)):
        sols = [tnls.solve(tnls.SteadyStateProblem(
            f, torch.tensor(u0, dtype=torch.float64, device=d),
            torch.tensor(p, dtype=torch.float64, device=d)),
            tnls.DynamicSS(method=method)) for d in (cuda, "cpu")]
        g, c = sols
        assert g.u.is_cuda and g.retcode == c.retcode
        assert g.stats == c.stats, (g.stats, c.stats)
        torch.testing.assert_close(g.u.cpu(), c.u, rtol=0, atol=1e-8)


@pytest.mark.cuda
def test_scc_chain_on_card_matches_cpu(cuda):
    """An SCC chain on the card and on the CPU (f64): Bratu 8² at λ = p,
    a linear block J(u₁*) x = −e^{u₁*} (du/dλ), and a homotopy block at
    λ·(p + mean u₁*), abstol 1e-10: the retcode and NLStats equal, u within
    1e-10, and ∂⟨w, u⟩/∂p within rel 1e-10."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.core.autodiff import jacfwd
    from nonlinearsolve_tpu_torch.models.bratu import bratu_2d
    out = {}
    for d in (cuda, "cpu"):
        p = torch.tensor(3.5, dtype=torch.float64,
                         device=d).requires_grad_(True)
        z = torch.zeros((8, 8), dtype=torch.float64, device=d)

        def jac(q):
            u1, lam = q
            return jacfwd(lambda v: bratu_2d(v.reshape(8, 8), lam)
                          .reshape(-1))(u1.reshape(-1))
        prob = tnls.SCCNonlinearProblem(
            [tnls.NonlinearProblem(bratu_2d, z, p),
             tnls.LinearSCCBlock(A=jac, b=lambda q: -torch.exp(q[0])
                                 .reshape(-1)),
             tnls.HomotopyProblem(_bratu_h, z, None)],
            explicitfuns=[None, lambda q, sols: (sols[0].u, q),
                          lambda q, sols: q + sols[0].u.mean()], p=p)
        sol = tnls.solve(prob, tnls.SCCAlg(nlalg=tnls.NewtonRaphson()),
                         abstol=1e-10)
        w = torch.linspace(0.5, 1.5, sol.u.numel(), dtype=torch.float64,
                           device=d)
        pbar, = torch.autograd.grad((w * sol.u).sum(), p)
        out[str(d)] = sol, float(pbar)
    (g, g_pbar), (c, c_pbar) = out[str(cuda)], out["cpu"]
    assert g.retcode == c.retcode == tnls.ReturnCode.Success
    assert g.stats == c.stats
    torch.testing.assert_close(g.u.detach().cpu(), c.u.detach(), rtol=0,
                               atol=1e-10)
    assert abs(g_pbar - c_pbar) <= 1e-10 * abs(c_pbar)


def _quadratic_system(n, seed):
    """A seeded dense quadratic system f_i(x) = Σ A_ijk x_j x_k + Σ B_ij x_j
    + c_i (one path's state), and its total degrees."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n, n)) / n
    B = rng.standard_normal((n, n)) / np.sqrt(n)
    c = rng.standard_normal(n)

    def make(device, dtype):
        tA, tB, tc = (torch.tensor(a, dtype=dtype, device=device)
                      for a in (A, B, c))
        return lambda x: torch.einsum("ijk,j,k->i", tA, x, x) + tB @ x + tc
    return make, (2,) * n


@pytest.mark.cuda
def test_poly_tracker_on_card_batch_equals_lone(cuda):
    """The lockstep path tracker on the card (complex128): on an
    elementwise system every path of the batch is its lone track bit for
    bit; on a seeded quadratic system (an einsum, which contracts
    otherwise at other batch sizes) the flags and steps are the CPU run's
    and the endpoints within 1e-10."""
    from nonlinearsolve_tpu_torch.solvers import poly_homotopy as tph
    c128 = torch.complex128
    alg = tph.PolynomialHomotopy(degrees=(2, 3), dt_initial=0.5)

    def f(x):
        return torch.stack([x[0] ** 2 + 3 * x[0] * x[1] - 1.0,
                            x[1] ** 3 - 4 * x[0] + 0.5])
    x, ok, steps = tph._track_paths(f, alg.degrees, alg, c128, cuda)
    starts = tph._start_roots(alg.degrees, c128, cuda)
    for i in range(starts.shape[0]):
        xi, oki, si = tph._track_paths(f, alg.degrees, alg, c128,
                                       starts=starts[i:i + 1])
        assert torch.equal(xi[0], x[i]) and bool(oki[0]) == bool(ok[i])
        assert int(si[0]) == int(steps[i])
    make, degrees = _quadratic_system(3, 0)
    alg = tph.PolynomialHomotopy(degrees=degrees)
    x, ok, steps = tph._track_paths(make(cuda, c128), degrees, alg, c128,
                                    cuda)
    xc, okc, stc = tph._track_paths(make("cpu", c128), degrees, alg, c128,
                                    "cpu")
    assert torch.equal(ok.cpu(), okc) and torch.equal(steps.cpu(), stc)
    torch.testing.assert_close(x.cpu()[okc], xc[okc], rtol=0, atol=1e-10)


def _poly_drivers_of_python_numbers(p):
    """The three polynomial entry points on a Python-number / list u0."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.solvers import poly_homotopy as tph
    poly = tph.solve_polynomial(
        tnls.NonlinearProblem(lambda x, q: torch.stack([x[0] ** 2 - q]),
                              [1.0], p),
        tph.PolynomialHomotopy(degrees=(2,)), real_only=True)
    hc = tnls.solve(tnls.NonlinearProblem(
        lambda u, q: u ** 2 - 6 * u + q - 1.0, 0.0, p),
        tnls.HomotopyContinuationJL(all_roots=True))
    ms = tnls.solve_multistart(tnls.NonlinearProblem(
        lambda u, q: torch.sin(u) - 0.0 * q, [1.0], p), order=3)
    return poly, hc, ms


def test_polynomial_drivers_of_python_numbers_need_cuda(monkeypatch):
    """A Python-number or list u0 and p: the polynomial drivers run on the
    card, and raise when there is no CUDA (no CPU fallback)."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.solvers import poly_homotopy as tph
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tph.solve_polynomial(tnls.NonlinearProblem(
            lambda x, q: torch.stack([x[0] ** 2 - q]), [1.0], 9.0),
            tph.PolynomialHomotopy(degrees=(2,)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnls.solve(tnls.NonlinearProblem(lambda u, q: u ** 2 - q, 1.0, 4.0),
                   tnls.HomotopyContinuationJL())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tnls.solve_multistart(tnls.NonlinearProblem(
            lambda u, q: torch.sin(u), [1.0], None))


@pytest.mark.cuda
def test_polynomial_drivers_of_python_numbers_on_card(cuda):
    """A Python-number or list u0 with no tensor anywhere: the polynomial
    drivers track on the card in complex128 and return f64 roots there,
    the CPU run's (``p`` a CPU tensor) within 1e-10."""
    g = _poly_drivers_of_python_numbers(9.0)
    c = _poly_drivers_of_python_numbers(torch.tensor(9.0,
                                                     dtype=torch.float64))
    assert g[0].original[0].is_cuda
    assert g[0].original[0].dtype == torch.complex128
    for gu, cu in ((g[0].u, c[0].u), (g[1].u, c[1].u), (g[2], c[2])):
        assert gu.is_cuda and gu.dtype == torch.float64
        assert gu.shape == cu.shape
        torch.testing.assert_close(gu.cpu().sort(0).values,
                                   cu.sort(0).values, rtol=0, atol=1e-10)


@pytest.mark.cuda
def test_complex_and_pytree_states_on_card(cuda):
    """u³ − 8 from −0.8 + 1.5i (complex128) under NewtonRaphson, Broyden,
    Klement and the default ladder, and the dict state of
    tests/test_core_solvers.py::test_pytree_state under NewtonRaphson, on
    the card: the CPU run's retcode and NLStats, the roots within 1e-14."""
    import nonlinearsolve_tpu_torch as tnls
    for name in ("NewtonRaphson", "Broyden", "Klement", None):
        sols = [tnls.solve(tnls.NonlinearProblem(
            lambda u, p: u ** 3 - p,
            torch.tensor([-0.8 + 1.5j], dtype=torch.complex128, device=d),
            8.0), None if name is None else getattr(tnls, name)())
            for d in (cuda, "cpu")]
        g, c = sols
        assert g.u.is_cuda and g.retcode == c.retcode
        assert g.stats == c.stats, (name, g.stats, c.stats)
        torch.testing.assert_close(g.u.cpu(), c.u, rtol=0, atol=1e-14)

    def f(u, p):
        return {"a": u["a"] ** 2 - p, "b": u["b"] ** 3 - p}
    sols = [tnls.solve(tnls.NonlinearProblem(f, {
        "a": torch.tensor([1.0, 1.5], dtype=torch.float64, device=d),
        "b": torch.tensor([1.0], dtype=torch.float64, device=d)}, 2.0),
        tnls.NewtonRaphson()) for d in (cuda, "cpu")]
    g, c = sols
    assert g.u["a"].is_cuda and g.retcode == c.retcode
    assert g.stats == c.stats
    for k in "ab":
        torch.testing.assert_close(g.u[k].cpu(), c.u[k], rtol=0, atol=1e-14)


@pytest.mark.cuda
def test_complex_krylov_and_repairs_on_card(cuda):
    """Complex GMRES and BiCGStab on the card against LU (cuSOLVER) on a
    seeded system; C.3 (u − p over a NaN row: the CPU run's codes) and C.4
    (a singular Jacobian: a NaN gradient, no exception) on the card."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.ops import krylov as tkry
    rng = np.random.default_rng(1)
    n = 200
    A = torch.tensor((rng.standard_normal((n, n))
                      + 1j * rng.standard_normal((n, n))) / np.sqrt(n)
                     + 3 * np.eye(n), device=cuda)
    b = torch.tensor(rng.standard_normal(n) + 1j * rng.standard_normal(n),
                     device=cuda)
    x_lu = torch.linalg.solve(A, b)
    for method in ("gmres", "bicgstab"):
        res = tkry.solve_krylov(method, lambda v: A @ v, b, rtol=1e-12,
                                maxiter=2000)
        assert res.success and res.x.is_cuda
        torch.testing.assert_close(res.x, x_lu, rtol=0, atol=1e-10)
    p = [0.3, float("nan"), 0.0, 1.0, 2.0]
    codes = []
    for d in (cuda, "cpu"):
        sol = tnls.solve(tnls.IntervalNonlinearProblem(
            lambda u, q: u - q, (torch.zeros(5, dtype=torch.float64,
                                             device=d),
                                 torch.ones(5, dtype=torch.float64,
                                            device=d)),
            torch.tensor(p, dtype=torch.float64, device=d)), tnls.Bisection())
        codes.append((sol.retcode.tolist(), sol.stats.nf.tolist()))
    assert codes[0] == codes[1]
    assert codes[0][0][1] == int(tnls.ReturnCode.Success)
    q = torch.tensor([-1.0, 2.0], dtype=torch.float64,
                     device=cuda).requires_grad_(True)
    sol = tnls.solve(tnls.NonlinearProblem(
        lambda u, r: u * u - r, torch.tensor([1.0, 1.5], dtype=torch.float64,
                                             device=cuda), q),
        tnls.NewtonRaphson(), maxiters=30)
    grad, = torch.autograd.grad(sol.u.sum(), q)
    assert torch.isnan(grad).all()


@pytest.mark.cuda
def test_ordered_engines_on_complex_states_on_card(cuda):
    """u³ − 8 from −0.8 + 1.5i (complex128, the default abstol) under the
    engines that order values (ROADMAP A.33): on the card, the CPU run's
    retcode and NLStats and its root within 1e-14; PseudoTransient refused
    on the card too.  The cube is written u·u·u, the JAX package's
    integer_pow: torch's complex ``pow`` on a CUDA tensor rounds off the
    product (ROADMAP C)."""
    import nonlinearsolve_tpu_torch as tnls
    for name in ("LevenbergMarquardt", "TrustRegion", "AndersonAcceleration",
                 "SimpleTrustRegion", "SimpleDFSane"):
        g, c = [tnls.solve(tnls.NonlinearProblem(
            lambda u, p: u * u * u - p,
            torch.tensor([-0.8 + 1.5j], dtype=torch.complex128, device=d),
            8.0), getattr(tnls, name)()) for d in (cuda, "cpu")]
        assert g.u.is_cuda and g.retcode == c.retcode, name
        assert g.stats == c.stats, (name, g.stats, c.stats)
        torch.testing.assert_close(g.u.cpu(), c.u, rtol=0, atol=1e-14)
    with pytest.raises(NotImplementedError, match="fails to trace"):
        tnls.solve(tnls.NonlinearProblem(
            lambda u, p: u * u * u - p,
            torch.tensor([-0.8 + 1.5j], dtype=torch.complex128, device=cuda),
            8.0), tnls.PseudoTransient())


@pytest.mark.cuda
def test_sparsity_detection_on_card(cuda):
    """``detect_sparsity`` traces a residual on the card: the flat 64²
    Brusselator's pattern is ``sparsity_pattern(64)``, the permuted
    residual's (pinv[rows], pinv[cols]); a data-dependent residual probes
    on the card and gets the CPU run's pattern."""
    from nonlinearsolve_tpu_torch.ops.coloring import detect_sparsity
    N = 64
    n = 2 * N * N
    p = tbru.default_p(N, device=cuda)
    pat = tbru.sparsity_pattern(N)
    got = detect_sparsity(
        lambda u: tbru.brusselator_2d(u.reshape(N, N, 2), p).reshape(-1), n,
        device=cuda)
    np.testing.assert_array_equal(got.indptr, pat.indptr)
    np.testing.assert_array_equal(got.indices, pat.indices)
    perm = np.random.default_rng(42).permutation(n)
    pinv = np.argsort(perm)
    perm_t, pinv_t = (torch.as_tensor(perm, device=cuda),
                      torch.as_tensor(pinv, device=cuda))
    gotp = detect_sparsity(lambda w: tbru.brusselator_2d(
        w[pinv_t].reshape(N, N, 2), p).reshape(-1)[perm_t], n, device=cuda)
    want = type(pat).from_pattern(pinv[pat.row_ids], pinv[pat.indices],
                                  (n, n))
    np.testing.assert_array_equal(gotp.indptr, want.indptr)
    np.testing.assert_array_equal(gotp.indices, want.indices)

    def dd(u):
        return u * u[torch.clamp(u[0].to(torch.int64), 0, 2)]
    g, c = (detect_sparsity(dd, 3, device=d) for d in (cuda, "cpu"))
    np.testing.assert_array_equal(g.indices, c.indices)
    np.testing.assert_array_equal(g.indptr, c.indptr)


@pytest.mark.cuda
def test_double_f32_refinement_on_card(cuda):
    """The error-free transforms are exact on the card on 2²⁰ seeded f32
    pairs; ``brusselator_2d_df32`` gives the CPU run's words; the N = 64
    flagship's f32 root refined with K1 as the Jacobian product lands
    within 1e-8 rel-inf of the f64 solve; ``auto_refine`` on Bratu 32² is
    the CPU run's refined root within 1e-12."""
    import nonlinearsolve_tpu_torch as tnls
    from nonlinearsolve_tpu_torch.models import bratu as tbratu
    from nonlinearsolve_tpu_torch.ops import doublef32 as dfm
    from nonlinearsolve_tpu_torch.ops.preconditioners import \
        fft_poisson_preconditioner
    rng = np.random.default_rng(0)
    a = torch.as_tensor(rng.standard_normal(1 << 20) * 1e4,
                        dtype=torch.float32, device=cuda)
    b = torch.as_tensor(rng.standard_normal(1 << 20), dtype=torch.float32,
                        device=cuda)
    s, e = dfm.two_sum(a, b)
    assert torch.equal(s.double() + e.double(), a.double() + b.double())
    p_, e = dfm.two_prod(a, b)
    assert torch.equal(p_.double() + e.double(), a.double() * b.double())
    assert dfm.self_check(cuda)
    N = 64
    U = tbru.init_u0(N, torch.float32, device=cuda)
    p64 = tbru.default_p(N, torch.float64, device="cpu")
    gh, gl = tbru.brusselator_2d_df32(U, torch.zeros_like(U), p64)
    ch, cl = tbru.brusselator_2d_df32(U.cpu(), torch.zeros_like(U.cpu()),
                                      p64)
    assert torch.equal(gh.cpu(), ch) and torch.equal(gl.cpu(), cl)
    pm = fft_poisson_preconditioner((N, N), alpha=10.0, h=1.0 / (N - 1),
                                    shift=3.0, n_components=2)
    prob = tbru.make_problem(N, torch.float32, kernel_jvp=True, device=cuda)
    alg = tnls.NewtonRaphson(
        linsolve=tnls.LinearSolver(method="gmres", restart=16,
                                   krylov_maxiter=100, precond_fn=pm),
        forcing=tnls.EisenstatWalkerForcing(eta_0=1e-2, eta_max=1e-2))
    sol = tnls.solve(prob, alg, abstol=0.05, maxiters=30)
    sol64 = tnls.solve(tbru.make_problem(N, torch.float64, device=cuda),
                       tnls.NewtonRaphson(linsolve=tnls.LinearSolver(
                           method="gmres", restart=16, krylov_maxiter=200,
                           precond_fn=pm)), abstol=1e-8, maxiters=50)
    p32 = prob.p
    before = dict(_backend.LAUNCHES)
    res = tnls.refine_root(
        sol.u, lambda uh, ul: tbru.brusselator_2d_df32(uh, ul, p64),
        lambda uh: (lambda v: tst.brusselator_jvp(uh, v, p32)),
        rounds=3, inner_rtol=1e-2, restart=16, precond_fn=pm)
    assert _backend.LAUNCHES["brusselator_jvp"] > before["brusselator_jvp"]
    u_ref = res.u.hi.double() + res.u.lo.double()
    scale = float(sol64.u.abs().max())
    assert float((u_ref - sol64.u).abs().max()) / scale < 1e-8
    refined = []
    for d in (cuda, "cpu"):
        prob32 = tbratu.make_problem(32, dtype=torch.float32, device=d)
        s32 = tnls.solve(prob32, tnls.NewtonRaphson(
            linsolve=tnls.LinearSolver(method="gmres", restart=32)),
            abstol=1e-3, maxiters=50)
        r = tnls.auto_refine(prob32, s32.u.cpu().to(d), rounds=4)
        refined.append(dfm.df_value_f64(r.u))
    assert np.abs(refined[0] - refined[1]).max() < 1e-12


@pytest.mark.cuda
def test_k5_on_sharded_csr_shard_tables_on_card(cuda):
    """K5 on a shard's local CSR tables (``parallel/sparse_dist.py``: the
    rebased row pointers, the columns remapped into the shard's x buffer,
    the data's contiguous run) against its plain version, f64 and f32, for
    each of 4 shards of a banded pattern in halo mode; one launch a
    call."""
    import scipy.sparse as sp

    from nonlinearsolve_tpu_torch.ops import spmv
    from nonlinearsolve_tpu_torch.parallel.sparse_dist import \
        build_sharded_csr_plan
    rng = np.random.default_rng(0)
    N = 256
    n = N * N
    d = np.ones(n)
    A = sp.diags([d * 4, -d[:-1], -d[:-1], -d[:-N], -d[:-N]],
                 [0, 1, -1, N, -N], format="csr")
    A.data = A.data * (1 + 0.1 * rng.standard_normal(A.nnz))
    S = 4
    plan = build_sharded_csr_plan(A.indptr, A.indices, n, S)
    assert plan.mode == "halo"
    x = rng.standard_normal(S * plan.chunk)
    for dtype in ("float64", "float32"):
        dt = TORCH_DT[dtype]
        for s in range(S):
            nnz = int(plan.shard_indptr[s, -1])
            lo = s * plan.chunk - plan.hl
            buf = x[np.arange(lo, lo + plan.buf_len) % x.size]
            args = (torch.as_tensor(plan.shard_indptr[s].astype(np.int32),
                                    device=cuda),
                    torch.as_tensor(plan.seg_pos[s, :nnz], device=cuda),
                    torch.as_tensor(A.data[plan.seg_src[s, :nnz]],
                                    dtype=dt, device=cuda),
                    torch.as_tensor(buf, dtype=dt, device=cuda))
            before = _backend.LAUNCHES["gather_spmv"]
            got = spmv.gather_spmv(*args)
            torch.cuda.synchronize()
            assert _backend.LAUNCHES["gather_spmv"] == before + 1
            _close(got, spmv.gather_spmv_plain(*args), dtype)
            rows = slice(s * plan.chunk, (s + 1) * plan.chunk)
            _close(got, torch.as_tensor(A[rows] @ x[:n]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bc,smoother", [("periodic", "jacobi"),
                                         ("dirichlet", "chebyshev")])
def test_multigrid_on_card_matches_cpu(cuda, bc, smoother):
    """``multigrid_preconditioner`` on a CUDA tensor against the same
    apply on the CPU: rel-inf 1e-12 in f64, 2D (256²) and 3D (64³), c a
    field."""
    from nonlinearsolve_tpu_torch.ops.multigrid import \
        multigrid_preconditioner
    for shape in ((256, 256), (64, 64, 64)):
        rng = np.random.default_rng(len(shape))
        c = torch.as_tensor(1.0 + 2.0 * rng.random(shape))
        v = torch.as_tensor(rng.standard_normal(shape))
        kw = dict(c=c, bc=bc, smoother=smoother, cycles=2)
        ref = multigrid_preconditioner(shape, 10.0, 1.0 / shape[0], **kw)(v)
        kw["c"] = c.to(cuda)
        got = multigrid_preconditioner(shape, 10.0, 1.0 / shape[0], **kw)(
            v.to(cuda))
        assert got.device.type == "cuda"
        _close(got, ref, "float64")

"""AOT export and loading (``utils/aot.py`` through ``torch.export``)
against the JAX package's ``tests/test_aot_export.py`` on the same inputs,
f64 on the CPU.

The four JAX tests, ported: the NewtonRaphson round trip equals the
in-process ``solve`` bit for bit and takes fresh inputs, the default
polyalgorithm with ``p = None``, and the symbolic batch at sizes 2 and 7
(the lockstep ensemble).  The JAX test that jits the loaded solver has no
counterpart (nothing here is traced); in its place a second call with
fresh inputs reuses the loaded program.  A fresh process loads the bytes
without the residual's source, and the refusals (trace options, a Python
callable in the algorithm, a device outside the platforms) hold.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls

torch.set_num_threads(1)

F64 = torch.float64


def quadratic(u, p):
    return u * u - p


def _t(x):
    return torch.tensor(x, dtype=F64)


def _roundtrip(data):
    assert isinstance(data, (bytes, bytearray)) and len(data) > 0
    return tnls.deserialize_solver(bytes(data))


def test_export_newton_roundtrip_matches_solve():
    prob = tnls.NonlinearProblem(quadratic, _t([1.0, 1.0]), 2.0)
    f = _roundtrip(tnls.export_solver(prob, tnls.NewtonRaphson(),
                                      abstol=1e-10))
    sol = f(_t([1.0, 1.0]), _t(2.0))
    ref = tnls.solve(prob, tnls.NewtonRaphson(), abstol=1e-10)
    assert torch.equal(sol.u, ref.u) and torch.equal(sol.resid, ref.resid)
    assert int(sol.retcode) == int(ref.retcode) == 1
    assert sol.stats == ref.stats and sol.stats.nsteps > 0
    # the JAX package's artifact, the same inputs: the same root and steps
    jprob = jnls.NonlinearProblem(quadratic, jnp.array([1.0, 1.0]), 2.0)
    jsol = jnls.deserialize_solver(jnls.export_solver(
        jprob, jnls.NewtonRaphson(), abstol=1e-10))(
            jnp.array([1.0, 1.0]), jnp.asarray(2.0))
    np.testing.assert_allclose(sol.u.numpy(), np.asarray(jsol.u),
                               rtol=1e-12, atol=0)
    assert int(jsol.stats.nsteps) == sol.stats.nsteps
    # fresh runtime inputs through the same artifact
    sol3 = f(_t([2.0, 2.0]), _t(3.0))
    np.testing.assert_allclose(sol3.u.numpy(), np.sqrt(3.0), rtol=1e-10)


def test_export_default_polyalg_and_p_none():
    prob = tnls.NonlinearProblem(lambda u, p: torch.cos(u) - u, _t([1.0]))
    f = _roundtrip(tnls.export_solver(prob, abstol=1e-10))
    sol = f(_t([0.1]))
    np.testing.assert_allclose((torch.cos(sol.u) - sol.u).numpy(), 0.0,
                               atol=1e-10)
    assert int(sol.retcode) == 1
    ref = tnls.solve(prob.remake(u0=_t([0.1])), abstol=1e-10)
    assert torch.equal(sol.u, ref.u) and sol.stats == ref.stats
    with pytest.raises(TypeError):
        f(_t([0.1]), _t(1.0))


def test_second_call_reuses_the_loaded_program(monkeypatch):
    """In place of the JAX test that jits the loaded solver: later calls
    with fresh inputs load nothing again and reuse the same program."""
    prob = tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0)
    data = tnls.export_solver(prob, tnls.NewtonRaphson(), abstol=1e-10)
    f = _roundtrip(data)
    loads = []
    real_load = torch.export.load
    monkeypatch.setattr(torch.export, "load",
                        lambda *a, **k: loads.append(1) or real_load(*a, **k))
    first = f(_t([1.0]), _t(5.0))
    module = f.residual.module("residual.pt2", torch.device("cpu"))
    second = f(_t([3.0]), _t(7.0))
    assert not loads
    assert f.residual.module("residual.pt2", torch.device("cpu")) is module
    np.testing.assert_allclose(first.u.numpy(), np.sqrt(5.0), rtol=1e-10)
    np.testing.assert_allclose(second.u.numpy(), np.sqrt(7.0), rtol=1e-10)


def test_export_symbolic_batch_serves_any_size():
    prob = tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0)
    f = _roundtrip(tnls.export_solver(prob, tnls.NewtonRaphson(),
                                      batch="b", abstol=1e-10))
    jf = jnls.deserialize_solver(jnls.export_solver(
        jnls.NonlinearProblem(quadratic, jnp.array([1.0]), 2.0),
        jnls.NewtonRaphson(), batch="b", abstol=1e-10))
    for n in (2, 7):   # one artifact, two different batch sizes
        u0s = torch.ones((n, 1), dtype=F64)
        ps = torch.arange(2.0, 2.0 + n, dtype=F64)
        sols = f(u0s, ps)
        assert sols.u.shape == (n, 1)
        assert sols.counters["ensemble_route"] == "lockstep"
        np.testing.assert_allclose(sols.u.numpy().ravel(), np.sqrt(ps.numpy()),
                                   rtol=1e-10)
        assert sols.retcode.tolist() == [1] * n
        jsols = jf(jnp.ones((n, 1)), jnp.arange(2.0, 2.0 + n))
        np.testing.assert_allclose(sols.u.numpy(), np.asarray(jsols.u),
                                   rtol=1e-10, atol=0)
    # a batch of one is padded to the program's two rows
    one = f(torch.ones((1, 1), dtype=F64), _t([9.0]))
    np.testing.assert_allclose(one.u.numpy().ravel(), [3.0], rtol=1e-10)


def test_refusals():
    prob = tnls.NonlinearProblem(quadratic, _t([1.0]), 2.0)
    with pytest.raises(ValueError, match="trace"):
        tnls.export_solver(prob, tnls.NewtonRaphson(), store_trace=True)
    # a precond_fn now crosses as a program (round trip below); a callable
    # that is neither a factory's product nor a precond_fn is refused
    # with its field's name
    with pytest.raises(ValueError, match="precondition"):
        tnls.export_solver(prob, tnls.NewtonRaphson(),
                           precondition=lambda fu, u, p: fu)
    alg = tnls.NewtonRaphson(linsolve=tnls.LinearSolver(
        method="gmres", precond_fn=lambda u: (lambda v: v / (1.0 + u * u))))
    g = _roundtrip(tnls.export_solver(prob, alg, abstol=1e-10))
    sol, ref = g(_t([1.0]), _t(2.0)), tnls.solve(prob, alg, abstol=1e-10)
    assert torch.equal(sol.u, ref.u) and sol.stats == ref.stats
    with pytest.raises(ValueError, match="platforms"):
        tnls.export_solver(prob, platforms=("tpu",))
    f = _roundtrip(tnls.export_solver(prob, tnls.NewtonRaphson()))
    with pytest.raises(ValueError, match="runs on"):
        f(torch.ones(1, dtype=F64, device="meta"), _t(2.0))


_LOADER = """
import json, sys, torch
import nonlinearsolve_tpu_torch as tnls
f = tnls.deserialize_solver(open(sys.argv[1], "rb").read())
sol = f(torch.tensor([1.0, 1.0], dtype=torch.float64),
        torch.tensor(2.0, dtype=torch.float64))
print(json.dumps({"u": sol.u.tolist(), "retcode": int(sol.retcode),
                  "nsteps": int(sol.stats.nsteps)}))
"""


def test_fresh_process_loads_without_the_residual(tmp_path):
    """The residual is defined here only; a fresh process that imports the
    port alone rebuilds it from the bytes."""
    def residual(u, p):
        return u * u * u - p * u - 1.0

    prob = tnls.NonlinearProblem(residual, _t([1.0, 1.0]), 2.0)
    path = tmp_path / "solver.bin"
    path.write_bytes(tnls.export_solver(prob, tnls.TrustRegion(),
                                        abstol=1e-12))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _LOADER, str(path)], cwd=str(tmp_path),
        env={**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    ref = tnls.solve(prob, tnls.TrustRegion(), abstol=1e-12)
    assert got["u"] == ref.u.tolist()
    assert got["retcode"] == int(ref.retcode) == 1
    assert got["nsteps"] == ref.stats.nsteps


@pytest.mark.parametrize("make", [
    lambda: tnls.NewtonRaphson(linesearch=tnls.BackTracking()),
    lambda: tnls.TrustRegion(radius_update_scheme="fan"),
    lambda: tnls.LevenbergMarquardt(disable_geodesic=True),
    lambda: tnls.Broyden(update_rule="bad_broyden"),
    lambda: tnls.Klement(),
    lambda: tnls.FastShortcutNonlinearPolyalg(u0_len=4),
    lambda: tnls.RobustMultiNewton(),
    lambda: tnls.NewtonRaphson(linsolve=tnls.LinearSolver(method="gmres"),
                               forcing=tnls.EisenstatWalkerForcing()),
])
def test_algorithms_cross_as_data(make):
    """The artifact carries an algorithm as its classes' names and
    fields: it comes back equal, and only the port's classes load."""
    from nonlinearsolve_tpu_torch.utils import aot
    alg = make()
    data = json.loads(json.dumps(aot._encode(alg, "alg")))
    assert aot._decode(data) == alg
    data["__dataclass__"] = "os:system"
    with pytest.raises(ValueError, match="outside the port"):
        aot._decode(data)


# ---------------------------------------------------------------------------
# templates that carry more than the residual (ROADMAP C.8): each exported,
# loaded here and in a fresh process, and held bit for bit to the port's
# in-process solve and to the JAX artifact's retcode and NLStats
# ---------------------------------------------------------------------------

_STATS = ("nf", "njacs", "nfactors", "nsolve", "nsteps")


def _diag_jac(lib):
    return lambda u, p: lib.diag(2.0 * u)


def _rolled(lib):
    def f(u, p):
        return u + 0.3 * (lib.roll(u, 1) + lib.roll(u, -1)) + 0.1 * u ** 3 - p
    return f


def _tridiagonal(n):
    rows = np.concatenate([np.arange(n)] * 3)
    cols = np.concatenate([np.arange(n), (np.arange(n) + 1) % n,
                           (np.arange(n) - 1) % n])
    return rows, cols


def _dict_f(u, p):
    return {"a": u["a"] * u["a"] - p, "b": u["b"] * u["b"] - 2.0 * p}


def _poisson(lib, alpha, h):
    def f(u, p):
        lap = (lib.roll(u, 1, 0) + lib.roll(u, -1, 0) + lib.roll(u, 1, 1)
               + lib.roll(u, -1, 1) - 4.0 * u) * (alpha / (h * h))
        return lap - u - 0.1 * u ** 3 + p
    return f


def _case(name):
    """(port problem, port alg, JAX problem, JAX alg, port call args, JAX
    call args, solve options, batch name)."""
    from nonlinearsolve_tpu.ops.preconditioners import (
        fft_poisson_preconditioner as jfft)

    from nonlinearsolve_tpu_torch.ops.preconditioners import (
        fft_poisson_preconditioner as tfft)
    opts = {"abstol": 1e-10}
    u2, ju2 = _t([1.0, 1.5]), jnp.array([1.0, 1.5])
    if name in ("jac_newton", "jac_default"):
        tp = tnls.NonlinearProblem(tnls.NonlinearFunction(
            quadratic, jac=_diag_jac(torch)), u2, 2.0)
        jp = jnls.NonlinearProblem(jnls.NonlinearFunction(
            quadratic, jac=_diag_jac(jnp)), ju2, 2.0)
        algs = ((tnls.NewtonRaphson(), jnls.NewtonRaphson())
                if name == "jac_newton" else (None, None))
        return (tp, algs[0], jp, algs[1], (u2, _t(3.0)),
                (ju2, jnp.asarray(3.0)), opts, None)
    if name == "bounds":
        tp = tnls.NonlinearProblem(quadratic, u2, 2.0, lb=_t([0.5, 0.5]),
                                   ub=_t([4.0, 4.0]))
        jp = jnls.NonlinearProblem(quadratic, ju2, 2.0,
                                   lb=jnp.array([0.5, 0.5]),
                                   ub=jnp.array([4.0, 4.0]))
        return (tp, tnls.NewtonRaphson(), jp, jnls.NewtonRaphson(),
                (u2, _t(3.0)), (ju2, jnp.asarray(3.0)), opts, None)
    if name == "sparsity":
        n = 8
        spec = _tridiagonal(n)
        tp = tnls.NonlinearProblem(tnls.NonlinearFunction(
            _rolled(torch), sparsity=spec), torch.zeros(n, dtype=F64), 1.0)
        jp = jnls.NonlinearProblem(jnls.NonlinearFunction(
            _rolled(jnp), sparsity=spec), jnp.zeros(n), 1.0)
        return (tp, tnls.NewtonRaphson(), jp, jnls.NewtonRaphson(),
                (torch.zeros(n, dtype=F64), _t(0.5)),
                (jnp.zeros(n), jnp.asarray(0.5)), opts, None)
    if name == "dict_u0":
        tu = {"a": _t([1.0]), "b": _t([1.0, 2.0])}
        ju = {"a": jnp.array([1.0]), "b": jnp.array([1.0, 2.0])}
        return (tnls.NonlinearProblem(_dict_f, tu, 2.0),
                tnls.NewtonRaphson(),
                jnls.NonlinearProblem(_dict_f, ju, 2.0), jnls.NewtonRaphson(),
                (tu, _t(3.0)), (ju, jnp.asarray(3.0)), opts, None)
    if name == "gmres_precond_fn":
        tlin = tnls.LinearSolver(method="gmres",
                                 precond_fn=lambda u: (lambda v: v / (2 * u)))
        jlin = jnls.LinearSolver(method="gmres",
                                 precond_fn=lambda u: (lambda v: v / (2 * u)))
        u4, ju4 = _t([1.0, 1.5, 2.0, 2.5]), jnp.array([1.0, 1.5, 2.0, 2.5])
        return (tnls.NonlinearProblem(quadratic, u4, 2.0),
                tnls.NewtonRaphson(linsolve=tlin),
                jnls.NonlinearProblem(quadratic, ju4, 2.0),
                jnls.NewtonRaphson(linsolve=jlin),
                (u4, _t(3.0)), (ju4, jnp.asarray(3.0)), opts, None)
    if name == "gmres_fft_factory":
        N, alpha = 8, 0.01
        h = 1.0 / N
        g = np.random.default_rng(21)
        b = g.uniform(0.0, 1.0, (N, N))
        tlin = tnls.LinearSolver(method="gmres",
                                 precond_fn=tfft((N, N), alpha, h))
        jlin = jnls.LinearSolver(method="gmres",
                                 precond_fn=jfft((N, N), alpha, h))
        tu, ju = torch.zeros((N, N), dtype=F64), jnp.zeros((N, N))
        return (tnls.NonlinearProblem(_poisson(torch, alpha, h), tu,
                                      torch.tensor(b)),
                tnls.NewtonRaphson(linsolve=tlin),
                jnls.NonlinearProblem(_poisson(jnp, alpha, h), ju,
                                      jnp.asarray(b)),
                jnls.NewtonRaphson(linsolve=jlin),
                (tu, torch.tensor(0.5 * b)), (ju, jnp.asarray(0.5 * b)),
                opts, None)
    if name == "batch_jac":
        tp = tnls.NonlinearProblem(tnls.NonlinearFunction(
            quadratic, jac=_diag_jac(torch)), u2, 2.0)
        jp = jnls.NonlinearProblem(jnls.NonlinearFunction(
            quadratic, jac=_diag_jac(jnp)), ju2, 2.0)
        us = torch.tensor([[1.0, 1.5], [2.0, 0.5], [3.0, 3.0]],
                          dtype=F64)
        ps = _t([2.0, 3.0, 5.0])
        return (tp, tnls.NewtonRaphson(), jp, jnls.NewtonRaphson(),
                (us, ps), (jnp.asarray(us.numpy()), jnp.asarray(ps.numpy())),
                opts, "b")
    if name == "initialization":
        def main(lib, stack):
            return lambda u, p: stack([u[0] + u[1] - p, u[1] ** 2 - u[0]])
        tdata = tnls.InitializationData(
            initializeprob=tnls.NonlinearProblem(
                lambda z, q: z ** 2 - q, _t([0.5]), 1.0),
            initializeprobmap=lambda sol: torch.cat([_t([1.0]), sol.u]),
            initializeprobpmap=lambda sol, p: p + 0.0 * sol.u[0])
        jdata = jnls.InitializationData(
            initializeprob=jnls.NonlinearProblem(
                lambda z, q: z ** 2 - q, jnp.array([0.5]), 1.0),
            initializeprobmap=lambda sol: jnp.concatenate(
                [jnp.array([1.0]), sol.u]),
            initializeprobpmap=lambda sol, p: p + 0.0 * sol.u[0])
        tp = tnls.NonlinearProblem(tnls.NonlinearFunction(
            f=main(torch, torch.stack), initialization_data=tdata),
            _t([9.0, 9.0]), 2.0)
        jp = jnls.NonlinearProblem(jnls.NonlinearFunction(
            f=main(jnp, jnp.stack), initialization_data=jdata),
            jnp.array([9.0, 9.0]), 2.0)
        return (tp, tnls.NewtonRaphson(), jp, jnls.NewtonRaphson(),
                (_t([9.0, 9.0]), _t(2.0)),
                (jnp.array([9.0, 9.0]), jnp.asarray(2.0)), opts, None)
    if name == "jvp_vjp":
        def fn(lib):
            return lib.NonlinearFunction(
                quadratic, jvp=lambda v, u, p: 2.0 * u * v,
                vjp=lambda v, u, p: 2.0 * u * v)
        lin = (tnls.LinearSolver(method="gmres"),
               jnls.LinearSolver(method="gmres"))
        return (tnls.NonlinearProblem(fn(tnls), u2, 2.0),
                tnls.NewtonRaphson(linsolve=lin[0]),
                jnls.NonlinearProblem(fn(jnls), ju2, 2.0),
                jnls.NewtonRaphson(linsolve=lin[1]),
                (u2, _t(3.0)), (ju2, jnp.asarray(3.0)), opts, None)
    raise KeyError(name)


CASES = ("jac_newton", "jac_default", "bounds", "sparsity", "dict_u0",
         "gmres_precond_fn", "gmres_fft_factory", "batch_jac",
         "initialization", "jvp_vjp")

_FRESH_LOADER = """
import sys, torch
import nonlinearsolve_tpu_torch as tnls
out = {}
for name in sys.argv[2:]:
    f = tnls.deserialize_solver(open(f"{sys.argv[1]}/{name}.bin", "rb").read())
    sol = f(*torch.load(f"{sys.argv[1]}/{name}.args.pt", weights_only=True))
    out[name] = {"u": sol.u, "resid": sol.resid,
                 "retcode": torch.as_tensor(sol.retcode).reshape(-1).tolist(),
                 "stats": [torch.as_tensor(getattr(sol.stats, k)).reshape(-1)
                           .tolist() for k in %r]}
torch.save(out, f"{sys.argv[1]}/fresh.pt")
print("ok")
""" % (_STATS,)


def _in_process(tp, talg, targs, opts, batch):
    if batch is None:
        return tnls.solve(tp.remake(u0=targs[0], p=targs[1]), talg, **opts)
    return tnls.solve_ensemble(tp, talg, u0s=targs[0], ps=targs[1], **opts)


def _leaves_equal(a, b):
    from nonlinearsolve_tpu_torch.utils.pytree import tree_flatten
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    return sa == sb and all(torch.equal(x, y) for x, y in zip(la, lb))


def _stats(sol):
    return [torch.as_tensor(getattr(sol.stats, k)).reshape(-1).tolist()
            for k in _STATS]


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """Every case exported, loaded here and (all in one) in a fresh
    process; with its in-process solve and the JAX artifact's solution."""
    tmp = tmp_path_factory.mktemp("aot_carried")
    got = {}
    for name in CASES:
        tp, talg, jp, jalg, targs, jargs, opts, batch = _case(name)
        data = tnls.export_solver(tp, talg, batch=batch, **opts)
        (tmp / f"{name}.bin").write_bytes(data)
        torch.save(targs, tmp / f"{name}.args.pt")
        if name == "initialization":
            # the JAX package's export cannot trace its own initialization
            # hook (TracerBoolConversionError at core/initialization.py:59):
            # held to its solve
            jsol = jnls.solve(jp.remake(u0=jargs[0], p=jargs[1]), jalg,
                              **opts)
        else:
            jsol = jnls.deserialize_solver(jnls.export_solver(
                jp, jalg, batch=batch, **opts))(*jargs)
        got[name] = {"loaded": tnls.deserialize_solver(data)(*targs),
                     "ref": _in_process(tp, talg, targs, opts, batch),
                     "jax": jsol}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-c", _FRESH_LOADER, str(tmp), *CASES],
        cwd=str(tmp), capture_output=True, text=True, timeout=240,
        env={**os.environ, "PYTHONPATH": repo, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    fresh = torch.load(tmp / "fresh.pt", weights_only=True)
    for name in CASES:
        got[name]["fresh"] = fresh[name]
    return got


@pytest.mark.parametrize("name", CASES)
def test_carried_template_round_trip(carried, name):
    c = carried[name]
    sol, ref, fresh, jsol = c["loaded"], c["ref"], c["fresh"], c["jax"]
    # the loaded solver is the in-process solve, bit for bit, here and in a
    # fresh process that has none of the template's Python callables
    assert _leaves_equal(sol.u, ref.u) and _leaves_equal(sol.resid, ref.resid)
    assert _stats(sol) == _stats(ref)
    ret = torch.as_tensor(sol.retcode).reshape(-1).tolist()
    assert ret == torch.as_tensor(ref.retcode).reshape(-1).tolist()
    assert _leaves_equal(fresh["u"], ref.u)
    assert _leaves_equal(fresh["resid"], ref.resid)
    assert fresh["retcode"] == ret and fresh["stats"] == _stats(ref)
    # the JAX artifact on the same inputs: its retcode and NLStats
    assert ret == np.asarray(jsol.retcode).reshape(-1).tolist()
    assert all(r == 1 for r in ret)
    assert _stats(sol) == [np.asarray(getattr(jsol.stats, k)).reshape(-1)
                           .tolist() for k in _STATS]


def test_loaded_callables_equal_the_template_callables():
    """Each carried callable, loaded, gives the template callable's bits:
    ``jac`` (dense and as a ``CSR`` on the stored pattern), ``jvp``,
    ``vjp``, and a factory's preconditioner made again from its call."""
    from nonlinearsolve_tpu_torch.ops.preconditioners import (
        fft_poisson_preconditioner)
    from nonlinearsolve_tpu_torch.ops.sparse import CSR
    from nonlinearsolve_tpu_torch.utils import aot
    rows, cols = _tridiagonal(6)

    def jac_csr(u, p):
        return CSR.from_pattern(rows, cols, (6, 6),
                                torch.cat([2.0 * u, 0.3 * u * 0 + 0.3,
                                           0.3 + 0.0 * u]))
    M = fft_poisson_preconditioner((4, 4), 0.5, 0.25)
    fn = tnls.NonlinearFunction(
        quadratic, jac=jac_csr, jvp=lambda v, u, p: 2.0 * u * v,
        vjp=lambda v, u, p: 3.0 * u * v,
        sparsity=CSR.from_pattern(rows, cols, (6, 6)))
    u = torch.linspace(0.5, 1.5, 6, dtype=F64)
    prob = tnls.NonlinearProblem(fn, u, 2.0)
    alg = tnls.NewtonRaphson(linsolve=tnls.LinearSolver(method="gmres",
                                                        precond_fn=M))
    loaded = aot._Loaded(tnls.export_solver(prob, alg))
    lf = loaded.function(u.device)
    v, p = torch.linspace(-1.0, 1.0, 6, dtype=F64), _t(2.0)
    got, want = lf.jac(u, p), fn.jac(u, p)
    assert isinstance(got, CSR) and torch.equal(got.data, want.data)
    assert (np.array_equal(got.indices, want.indices)
            and np.array_equal(got.indptr, want.indptr)
            and got.shape == want.shape)
    assert torch.equal(lf.jvp(v, u, p), fn.jvp(v, u, p))
    assert torch.equal(lf.vjp(v, u, p), fn.vjp(v, u, p))
    assert np.array_equal(lf.sparsity.indptr, fn.sparsity.indptr)
    assert np.array_equal(lf.sparsity.indices, fn.sparsity.indices)
    x = torch.linspace(0.0, 1.0, 16, dtype=F64).reshape(4, 4)
    assert torch.equal(loaded.alg.descent.linsolve.precond_fn(x), M(x))

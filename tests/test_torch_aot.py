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
    alg = tnls.NewtonRaphson(linsolve=tnls.LinearSolver(
        method="gmres", precond_fn=lambda u: (lambda v: v)))
    with pytest.raises(ValueError, match="precond_fn"):
        tnls.export_solver(prob, alg)
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

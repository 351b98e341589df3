"""Batches on the simple tier, on the CPU (f64): a lockstep batch against
its lone solves and against the JAX package.

- A batch of 64 seeded starts must equal its 64 lone solves bit for bit
  (u, fu, retcode, NLStats): a finished row keeps its carry, as a finished
  lane of a vmapped ``while_loop`` does, and every operation acts on each
  row alone.
- A batch over p must give, row for row, the JAX package's lone solve:
  the same retcode and NLStats and a root within rel 1e-12
  (``ROOT_RTOL``).  The JAX package's own vmapped batch is not always its
  lone solves: XLA fuses the vmapped loop otherwise and rounds otherwise,
  and on 7 of these 16 SimpleKlement rows the vmapped step counts differ
  from the lone ones (``JAX_VMAP_PARTS``; ROADMAP C).  The port holds to
  the lone solve.
- Named exception: SimpleDFSane's rows that run all 100 steps without
  converging (MaxIters) agree in retcode and steps, but their line
  searches part at the ulp level and count other numbers of residuals
  (``DFSANE_NF``, measured: the JAX package's nf, the port's).

The residuals are written as XLA evaluates the JAX ones (one fused
multiply-add for ``u0² + u1`` and ``u0·u2 + u2``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu_torch as tnls
from test_torch_simple import ENGINES, STATS, _bits_equal, _jtrig, _t, _ttrig

torch.set_num_threads(1)

ROOT_RTOL = 1e-12
PS = np.linspace(0.5, 4.0, 16)

# p -> (JAX nf, port nf) of the SimpleDFSane rows that end in MaxIters
DFSANE_NF = {0.5: (1033, 1053), 3.066666666666667: (887, 917),
             3.3: (547, 523), 3.533333333333333: (1161, 1167),
             3.7666666666666666: (917, 941)}
# SimpleKlement rows whose vmapped JAX solve counts other steps than the
# lone one: p -> (vmapped nsteps, lone nsteps)
JAX_VMAP_PARTS = {1.6666666666666667: (87, 96), 1.9: (89, 87),
                  2.1333333333333333: (82, 84), 2.3666666666666667: (80, 83),
                  2.6: (74, 75), 2.8333333333333335: (75, 82),
                  3.066666666666667: (69, 77)}

BATCH_ENGINES = ["SimpleNewtonRaphson", "SimpleBroyden",
                 "SimpleBroyden-linesearch", "SimpleKlement", "SimpleDFSane",
                 "SimpleHalley", "SimpleTrustRegion",
                 "SimpleTrustRegion-NLsolve", "SimpleLimitedMemoryBroyden",
                 "SimpleLimitedMemoryBroyden-ring"]


def _starts():
    rng = np.random.default_rng(13)
    starts = rng.uniform(-2.0, 3.0, size=(64, 3))
    starts[5] = [0.0, 0.0, 0.0]           # a singular Jacobian at u0
    return starts


@pytest.mark.parametrize("name", BATCH_ENGINES)
def test_batch_equals_lone_solves(name):
    """64 seeded starts of the coupled problem in one lockstep batch: each
    row is its lone solve, bit for bit."""
    make = ENGINES[name]
    starts = _starts()
    prob = tnls.NonlinearProblem(_ttrig, _t(starts[0]), 1.5)
    batch = tnls.solve_ensemble(prob, make(tnls), u0s=_t(starts),
                                maxiters=40)
    assert batch.u.shape == (64, 3) and batch.retcode.shape == (64,)
    for i in range(64):
        lone = tnls.solve(prob.remake(u0=_t(starts[i])), make(tnls),
                          maxiters=40)
        assert int(batch.retcode[i]) == int(lone.retcode), i
        assert {k: int(getattr(batch.stats, k)[i]) for k in STATS} == \
            {k: getattr(lone.stats, k) for k in STATS}, i
        assert _bits_equal(batch.u[i], lone.u), i
        assert _bits_equal(batch.resid[i], lone.resid), i
    if "ring" not in name and name != "SimpleKlement":
        # rows stop at many steps (the rank-2 ring and Klement run all 40
        # on every row)
        assert len(set(batch.stats.nsteps.tolist())) > 1


@pytest.mark.parametrize("name", ["SimpleNewtonRaphson", "SimpleKlement",
                                  "SimpleDFSane", "SimpleHalley",
                                  "SimpleTrustRegion"])
def test_batch_over_ps_against_jax(name):
    """A batch over p: each row the JAX package's lone solve."""
    def jone(p):
        s = jnls.solve(jnls.NonlinearProblem(
            _jtrig, jnp.array([1.0, 0.2, 0.3]), p), getattr(jnls, name)(),
            maxiters=100)
        return (s.u, s.retcode) + tuple(getattr(s.stats, k) for k in STATS)

    tsol = tnls.solve_ensemble(
        tnls.NonlinearProblem(_ttrig, _t([1.0, 0.2, 0.3])),
        getattr(tnls, name)(), ps=_t(PS), maxiters=100)
    for r, p in enumerate(PS):
        j = jone(jnp.float64(p))
        got = {k: int(getattr(tsol.stats, k)[r]) for k in STATS}
        want = {k: int(v) for k, v in zip(STATS, j[2:])}
        assert int(tsol.retcode[r]) == int(j[1]), p
        if name == "SimpleDFSane" and p in DFSANE_NF:
            assert (want["nf"], got["nf"]) == DFSANE_NF[p]
            assert int(j[1]) == int(tnls.ReturnCode.MaxIters)
            want.pop("nf"), got.pop("nf")
        else:
            np.testing.assert_allclose(tsol.u[r].numpy(), np.asarray(j[0]),
                                       rtol=ROOT_RTOL, atol=1e-14)
        assert got == want, p
    if name == "SimpleKlement":
        jv = jax.vmap(jone)(jnp.asarray(PS))
        parts = {float(p): (int(jv[6][r]), int(tsol.stats.nsteps[r]))
                 for r, p in enumerate(PS)
                 if int(jv[6][r]) != int(tsol.stats.nsteps[r])}
        assert parts == JAX_VMAP_PARTS


def test_host_reads_of_a_batch():
    """One flag read a step (is any row still running?), none a row: the
    slowest row's steps plus one; a lone solve adds one read for its
    retcode and counts."""
    starts = _starts()[:16]
    prob = tnls.NonlinearProblem(_ttrig, _t(starts[0]), 1.5)
    batch = tnls.solve_ensemble(prob, tnls.SimpleNewtonRaphson(),
                                u0s=_t(starts), maxiters=40)
    assert batch.counters["host_syncs"] == \
        int(batch.stats.nsteps.max()) + 1
    lone = tnls.solve(prob, tnls.SimpleNewtonRaphson(), maxiters=40)
    assert lone.counters["host_syncs"] == lone.stats.nsteps + 2

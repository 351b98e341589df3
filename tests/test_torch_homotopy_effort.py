"""The continuation methods' effort caps against the JAX package (the
``homotopy_effort_tests`` cases of ``tests/test_homotopy_scc.py``), f64 on
the CPU: the interior tracking cap that keeps a rejected step from burning
the whole inner budget, and the step cap that ends a creeping sweep with
``MaxIters``.  Each run is held to the JAX package's retcode and
``NLStats`` and a root within 1e-10 (``test_torch_homotopy.py``'s
``assert_same``).  The uncapped run takes the full inner budget at every
bisection (24,034 Newton steps): about 40 s of the port's host loop.
"""

import torch

import nonlinearsolve_tpu_torch as tnls
from test_torch_homotopy import H_linear, assert_same, both, nr_inner

torch.set_num_threads(1)


def H_fold_half(u, p, lam):
    return u ** 2 + lam - 0.5


def test_sweep_tracking_cap_makes_rejections_cheap():
    nf = {}
    for cap in (None, 10, 20):
        jsol, tsol = both(H_fold_half, [0.7], None,
                          nr_inner(tracking_maxiters=cap))
        assert_same(jsol, tsol)
        assert not tsol.success
        nf[cap] = tsol.stats.nf
    assert nf[20] < nf[None] / 4 and nf[10] < nf[None] / 4


def test_sweep_maxsteps_cap_returns_maxiters():
    for make in (nr_inner(initial_step_factor=1e-4, expand_factor=1,
                          maxsteps=50),
                 lambda m: m.SimpleHomotopySweep(initial_step_factor=1e-4,
                                                 expand_factor=1,
                                                 maxsteps=50)):
        jsol, tsol = both(H_linear, [0.0], None, make)
        assert_same(jsol, tsol)
        assert tsol.retcode == tnls.ReturnCode.MaxIters
        assert 0.0 < float(tsol.u[0]) < 1.0

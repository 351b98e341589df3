"""The problem and function dataclasses of the port against the JAX
package's (ROADMAP C.9): the same field names in the same order, so a
keyword or positional construction means the same in both, and
``NonlinearFunction``'s ``resid_prototype`` (its 8th field, read by no
solver in either package) is carried.
"""

import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nonlinearsolve_tpu as jnls
import nonlinearsolve_tpu.core.initialization as jinit
import nonlinearsolve_tpu.core.problems as jproblems
import nonlinearsolve_tpu.solvers.homotopy_continuation as jhc
import nonlinearsolve_tpu_torch as tnls
import nonlinearsolve_tpu_torch.core.initialization as tinit
import nonlinearsolve_tpu_torch.core.problems as tproblems
import nonlinearsolve_tpu_torch.solvers.homotopy_continuation as thc

torch.set_num_threads(1)


def _dataclasses(module):
    return sorted(name for name, cls in inspect.getmembers(
        module, inspect.isclass)
        if dataclasses.is_dataclass(cls) and cls.__module__ == module.__name__)


PAIRS = [(j, t, name) for j, t in ((jproblems, tproblems), (jinit, tinit),
                                   (jhc, thc))
         for name in _dataclasses(j)]


def test_every_problem_dataclass_is_paired():
    names = {name for _, _, name in PAIRS}
    assert {"NonlinearFunction", "NonlinearProblem",
            "NonlinearLeastSquaresProblem", "IntervalNonlinearProblem",
            "SteadyStateProblem", "HomotopyProblem", "SCCNonlinearProblem",
            "InitializationData", "HomotopyNonlinearFunction"} <= names
    for j, t, name in PAIRS:
        assert _dataclasses(t).count(name) == 1, name


@pytest.mark.parametrize("jmod,tmod,name", PAIRS,
                         ids=[name for _, _, name in PAIRS])
def test_fields_in_the_jax_order(jmod, tmod, name):
    jf = [f.name for f in dataclasses.fields(getattr(jmod, name))]
    tf = [f.name for f in dataclasses.fields(getattr(tmod, name))]
    assert tf == jf


def test_resid_prototype_is_carried_and_read_by_no_solver():
    def f(u, p):
        return u * u - p

    proto = torch.zeros(2, dtype=torch.float64)
    fn = tnls.NonlinearFunction(f, resid_prototype=proto)
    assert fn.resid_prototype is proto and fn.initialization_data is None
    # the 8th positional field is resid_prototype, as in the JAX package
    pos = tnls.NonlinearFunction(f, None, None, None, None, None, None,
                                 proto)
    jpos = jnls.NonlinearFunction(f, None, None, None, None, None, None,
                                  jnp.zeros(2))
    assert pos.resid_prototype is proto and pos.initialization_data is None
    assert jpos.initialization_data is None
    u0 = torch.tensor([1.0, 1.0], dtype=torch.float64)
    sol = tnls.solve(tnls.NonlinearProblem(fn, u0, 2.0), tnls.NewtonRaphson(),
                     abstol=1e-12)
    ref = tnls.solve(tnls.NonlinearProblem(f, u0, 2.0), tnls.NewtonRaphson(),
                     abstol=1e-12)
    jsol = jnls.solve(jnls.NonlinearProblem(jpos, jnp.array([1.0, 1.0]),
                                            2.0), jnls.NewtonRaphson(),
                      abstol=1e-12)
    assert torch.equal(sol.u, ref.u) and sol.stats == ref.stats
    np.testing.assert_allclose(sol.u.numpy(), np.asarray(jsol.u), rtol=1e-14)
    assert sol.stats.nsteps == int(jsol.stats.nsteps)

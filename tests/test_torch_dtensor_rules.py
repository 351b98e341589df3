"""The port's DTensor sharding rules (``parallel/dtensor_rules.py``,
ROADMAP C.6): the AD J·v (``core.autodiff.jvp``, the VJP of the VJP) of a
state sharded over a one-axis gloo mesh of 2 and 4 processes, against
``torch.func.jvp`` on the whole tensor.

Each case is one way a residual reaches the components of a (16, 16, 2)
f64 state, run with the state in ``Shard(0)`` and in ``Shard(1)``
(``distributed_solve``'s ``shard_axis``): the J·v within 1e-12 relative of
the unsharded one, in the state's placements, and the residual equal to
the unsharded residual.  An idiom that reaches its components without a
roll takes no collective in its J·v (``CommDebugMode``): the state is not
gathered.  Before the rules, select, unbind and ``movedim`` then select
failed in ``aten.select_backward`` with ``dim = -1`` (its rule moved every
shard up by one), under torch 2.11 and 2.13; under torch 2.11
``torch.stack(..., -1)`` of ``Shard(1)`` inputs claimed ``Shard(2)`` too.
The reaction–diffusion J·v that ``distributed_solve``'s one-axis checks
run (``tests/test_torch_distributed_solve.py``) takes 12 all_gathers per
product, as before the rules.

The idioms run at world 1 too (no collective there), and the roll and
``index_put`` rules the port adds where torch lacks them (C.10: torch
2.11 has no rule for ``aten.roll``, and its ``index_put`` rule refuses the
``None`` entries of ``X[..., idx]``'s VJP and of ``index_select``'s, which
reaches ``index_put`` through ``aten.index_add``'s decomposition) are held
to torch's own where this torch has them: the same single-dimension rows
on the same arguments, and ``register()`` leaving torch's rules in
place.

This file runs itself as the worker (``python
tests/test_torch_dtensor_rules.py --worker RANK WORLD PORT OUT``): one
gloo launch per world size, whose rank 0 writes every case's outcome to
OUT as JSON.
"""

import json
import os
import socket
import subprocess
import sys
import time

import pytest
import torch

torch.set_num_threads(1)

IDIOMS = ("select_stack", "unbind_stack", "slice_cat", "narrow_cat",
          "split_cat", "chunk_cat", "index_tensor", "index_select",
          "movedim_select", "torch_roll", "backend_roll", "brusselator_2d")
# the idioms whose residual rolls the sharded grid: DTensor's roll and cat
# rules gather there, in the residual as in its J·v
ROLLS = ("torch_roll", "backend_roll", "brusselator_2d")
RD_GATHERS_PER_PRODUCT = 12


def _combine(a, b):
    return torch.stack([a * a * b - a, b * a + 2.0 * b], dim=-1)


def _pair_cat(a, b):
    return torch.cat([a * b, b * b - a], dim=-1)


def _residual(name):
    from nonlinearsolve_tpu_torch import _backend
    from nonlinearsolve_tpu_torch.models import brusselator

    swap = torch.tensor([1, 0])
    p = brusselator.default_p(16, device="cpu")
    return {
        "select_stack": lambda X: _combine(X[..., 0], X[..., 1]),
        "unbind_stack": lambda X: _combine(*X.unbind(-1)),
        "slice_cat": lambda X: _pair_cat(X[..., 0:1], X[..., 1:2]),
        "narrow_cat": lambda X: _pair_cat(X.narrow(-1, 0, 1),
                                          X.narrow(-1, 1, 1)),
        "split_cat": lambda X: _pair_cat(*X.split(1, dim=-1)),
        "chunk_cat": lambda X: _pair_cat(*X.chunk(2, dim=-1)),
        "index_tensor": lambda X: X * X[..., swap],
        "index_select": lambda X: X * X.index_select(-1, swap),
        "movedim_select": lambda X: _combine(X.movedim(-1, 0)[0],
                                             X.movedim(-1, 0)[1]),
        "torch_roll": lambda X: X * torch.roll(X, 1, 0)
        - torch.roll(X, -1, 1),
        "backend_roll": lambda X: X * _backend.roll(X, 1, 0)
        - _backend.roll(X, -1, 1),
        "brusselator_2d": lambda X: brusselator.brusselator_2d(X, p),
    }[name]


# ---------------------------------------------------------------------------
# the worker
# ---------------------------------------------------------------------------

def _gathers(comm) -> int:
    return int(sum(comm.get_comm_counts().values()))


def _one_case(f, X, T, mesh, shard):
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from nonlinearsolve_tpu_torch.core.autodiff import jvp

    Xs = distribute_tensor(X, mesh, [Shard(shard)], src_data_rank=None)
    Ts = distribute_tensor(T, mesh, [Shard(shard)], src_data_rank=None)
    comm = CommDebugMode()
    with implicit_replication(), comm:
        fu, jv = jvp(f, Xs, Ts)
    want_fu, want = torch.func.jvp(f, (X,), (T,))
    err = (jv.full_tensor() - want).abs().max() / want.abs().max()
    return {"err": float(err),
            "fu_equal": bool(torch.equal(fu.full_tensor(), want_fu)),
            "placements": [repr(q) for q in jv.placements],
            "want": [repr(Shard(shard))],
            "collectives": _gathers(comm)}


def _rd_case(mesh):
    """The reaction–diffusion J·v of ``_check_distributed_solve``: its
    collectives per product."""
    from torch.distributed.tensor import Shard, distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from nonlinearsolve_tpu_torch.core.autodiff import jvp
    from nonlinearsolve_tpu_torch.models import reaction_diffusion

    prob = reaction_diffusion.make_problem(16, device="cpu")
    us = distribute_tensor(prob.u0, mesh, [Shard(0)], src_data_rank=None)
    comm = CommDebugMode()
    with implicit_replication(), comm:
        _, jv = jvp(lambda U: prob.f.f(U, prob.p), us, us)
    return {"collectives": _gathers(comm),
            "placements": [repr(q) for q in jv.placements]}


def _worker(rank, world, port, out):
    import torch.distributed as dist

    from nonlinearsolve_tpu_torch.parallel import create_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = create_mesh()
        g = torch.Generator().manual_seed(20)
        X = torch.rand(16, 16, 2, dtype=torch.float64, generator=g) + 0.5
        T = torch.randn(16, 16, 2, dtype=torch.float64, generator=g)
        results = {}
        for name in IDIOMS:
            f = _residual(name)
            results[name] = {}
            for shard in (0, 1):
                try:
                    results[name][shard] = _one_case(f, X, T, mesh, shard)
                except (RuntimeError, IndexError, NotImplementedError) as e:
                    # every rank fails alike: the case records the op's
                    # message and the next one runs
                    results[name][shard] = {"error": f"{type(e).__name__}: "
                                            f"{str(e).splitlines()[0]}"}
        results["reaction_diffusion"] = _rd_case(mesh)
        if rank == 0:
            with open(out, "w") as fh:
                json.dump(results, fh)
    finally:
        dist.destroy_process_group()
    print(f"worker {rank}/{world} ok", flush=True)


# ---------------------------------------------------------------------------
# the launches
# ---------------------------------------------------------------------------

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(world, out, deadline):
    """Run ``world`` gloo workers on a free local port; their return codes
    and outputs.  Every worker is killed at ``deadline`` (a
    ``time.monotonic()`` value)."""
    port = str(_free_port())
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": repo + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", str(r),
         str(world), port, out], env=env,
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


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """``{world: results}`` of one gloo launch per world size; the launches
    (and up to three tries each, for a port another process took) share
    one deadline."""
    deadline = time.monotonic() + 120.0
    got = {}
    for world in (1, 2, 4):
        out = str(tmp_path_factory.mktemp(f"dtensor_rules_{world}")
                  / "results.json")
        for _ in range(3):
            rcs, outs = _run_workers(world, out, deadline)
            if not any("ddress already in use" in o for o in outs):
                break
        for r, (rc, o) in enumerate(zip(rcs, outs)):
            assert rc == 0, f"rank {r} of {world}:\n{o}"
        with open(out) as fh:
            got[world] = json.load(fh)
    return got


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("idiom", IDIOMS)
def test_sharded_jvp_matches_unsharded(outcomes, idiom, world):
    for shard, case in outcomes[world][idiom].items():
        where = f"{idiom}, Shard({shard}), world {world}"
        assert "error" not in case, f"{where}: {case.get('error')}"
        assert case["err"] <= 1e-12, (where, case["err"])
        assert case["placements"] == case["want"], (where, case)
        assert case["fu_equal"], where
        if idiom not in ROLLS:
            assert case["collectives"] == 0, (where, case["collectives"])


@pytest.mark.parametrize("world", [2, 4])
def test_reaction_diffusion_jvp_collectives_unchanged(outcomes, world):
    case = outcomes[world]["reaction_diffusion"]
    assert case["placements"] == ["Shard(dim=0)"], case
    assert case["collectives"] == RD_GATHERS_PER_PRODUCT, case


# ---------------------------------------------------------------------------
# the C.10 rules against torch's own
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float64):
    from torch.distributed.tensor._dtensor_spec import TensorMeta
    t = torch.empty(shape, dtype=dtype)
    return TensorMeta(t.shape, t.stride(), t.dtype)


def _rows(rows):
    return [[repr(q) for q in row] for row in rows]


def _torch_rule(name):
    """torch's own single-dimension rule of this name, or None where this
    torch has none."""
    from torch.distributed.tensor._ops import _tensor_ops
    return getattr(_tensor_ops, name, None)


_ROLLS = [([0], [1]), ([1], [1]), ([-1], [1]), ([0, 1], [1, -1]), ([], [1])]
_IDX = _meta(2, dtype=torch.int64)
_PUTS = [((None, None, _IDX), _meta(16, 16, 2)), ((_IDX,), _meta(2, 16, 2)),
         ((None, _IDX), _meta(16, 2, 2)), ((_IDX, None, _IDX), _meta(2, 16)),
         ((None, None, _IDX), _meta(2)), ((None, None, _IDX), _meta(1, 16, 2))]


@pytest.mark.parametrize("case", range(len(_ROLLS)))
def test_roll_rule_matches_torch(case):
    from nonlinearsolve_tpu_torch.parallel import dtensor_rules
    own = _torch_rule("roll_single_dim_strategy")
    if own is None:
        pytest.skip("this torch has no roll rule to compare with")
    dims, shifts = _ROLLS[case]
    args = ((_meta(16, 16, 2), shifts, dims) if dims
            else (_meta(16, 16, 2), shifts))
    op = torch.ops.aten.roll.default
    assert (_rows(dtensor_rules.roll_strategy(op, args, {}))
            == _rows(own(op, args, {})))


@pytest.mark.parametrize("case", range(len(_PUTS)))
def test_index_put_rule_matches_torch(case):
    from nonlinearsolve_tpu_torch.parallel import dtensor_rules
    own = _torch_rule("index_put_single_dim_strategy")
    if own is None:
        pytest.skip("this torch has no single-dimension index_put rule")
    indices, values = _PUTS[case]
    args = (_meta(16, 16, 2), indices, values)
    op = torch.ops.aten.index_put.default
    assert (_rows(dtensor_rules.index_put_strategy(op, args, {}))
            == _rows(own(op, args, {})))


def test_register_keeps_torch_rules():
    """A second ``register()`` changes no entry of roll's, index_put's,
    index.Tensor's or index_add's; each is torch's own rule where torch
    has one, else the port's: where torch has a single-dimension
    ``index_put`` rule, ``index_add`` keeps no rule (it propagates through
    its decomposition, as torch does), else it takes the port's."""
    from torch.distributed.tensor import DTensor

    from nonlinearsolve_tpu_torch.parallel import dtensor_rules
    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    tables = (prop.op_strategy_funcs, prop.op_single_dim_strategy_funcs,
              prop.op_to_rules)
    ops = (aten.roll.default, aten.index_put.default,
           aten.index_put_.default, aten._index_put_impl_.default,
           aten.index.Tensor, aten.index_add.default,
           aten.index_add_.default)
    before = [[t.get(op) for t in tables] for op in ops]
    dtensor_rules.register()
    assert [[t.get(op) for t in tables] for op in ops] == before
    own = _torch_rule("roll_single_dim_strategy")
    got = prop.op_single_dim_strategy_funcs[aten.roll.default].func
    assert got is (own if own is not None else dtensor_rules.roll_strategy)
    own = _torch_rule("index_put_single_dim_strategy")
    if own is not None:
        # torch's own rules, and index_add through its decomposition
        got = prop.op_single_dim_strategy_funcs[aten.index_put.default].func
        assert got is own
        assert not any(aten.index_add.default in t for t in tables)
    else:
        got = prop.op_strategy_funcs[aten.index_put.default]
        assert got.__qualname__.startswith("_index_put_rule")
        got = prop.op_single_dim_strategy_funcs[aten.index_add.default].func
        assert got is dtensor_rules.index_add_strategy


@pytest.mark.parametrize("dim", [0, 1, -1])
def test_index_add_rule_is_index_put_on_its_decomposition(dim):
    """``index_add``'s rows are torch's ``index_put`` rows on the
    decomposition ``index_put(self, (None,) * dim + (index,), source)``,
    where 2.13's propagation of ``index_add`` ends."""
    from nonlinearsolve_tpu_torch.parallel import dtensor_rules
    own = _torch_rule("index_put_single_dim_strategy")
    if own is None:
        pytest.skip("this torch has no single-dimension index_put rule")
    shape = [16, 16, 2]
    d = dim % 3
    source = _meta(*[2 if k == d else n for k, n in enumerate(shape)])
    args = (_meta(*shape), dim, _IDX, source)
    put = (_meta(*shape), (None,) * d + (_IDX,), source)
    assert (_rows(dtensor_rules.index_add_strategy(
        torch.ops.aten.index_add.default, args, {}))
            == _rows(own(torch.ops.aten.index_put.default, put, {})))


if __name__ == "__main__" and sys.argv[1:2] == ["--worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])

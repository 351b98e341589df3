"""What tracing costs ``auto_refine``: Bratu N² (default 128², f32, solved
by the sparse direct route at abstol 1e-2) refined as ``chip_smoke.py``
phase 26 (d) refines it, with the residual traced once
(``ops.doublef32_eval.df_trace``, as ``auto_refine`` does) and, for
comparison, traced again at every defect (``df_eval`` per defect, as
before).  Alternates the two, ``--pairs`` times each (one, two, two,
one, ...), and prints one JSON line a run (wall, the number of traces,
the refined root's rel-inf gap to the other variant's) and one with the
seconds of one trace (narrow and wide) and of one evaluation of the
traced graph.

    python3 tools/auto_refine_trace_cost.py             # on the card
    python3 tools/auto_refine_trace_cost.py --cpu --n 16
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nonlinearsolve_tpu_torch as nls                        # noqa: E402
from nonlinearsolve_tpu_torch.models import bratu             # noqa: E402
from nonlinearsolve_tpu_torch.ops import _graph               # noqa: E402
from nonlinearsolve_tpu_torch.ops import doublef32_eval as dfe  # noqa: E402
from nonlinearsolve_tpu_torch.ops.doublef32 import DF         # noqa: E402


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    dev = torch.device("cpu" if args.cpu else "cuda")
    traces = [0]
    real_trace = _graph.trace

    def counting_trace(*a, **k):
        traces[0] += 1
        return real_trace(*a, **k)
    _graph.trace = counting_trace
    real_df_trace = dfe.df_trace

    def per_defect(fn, *examples, trace_wide=True):
        # df_eval's behaviour: a fresh trace at every call
        return lambda *a, rules=None: real_df_trace(
            fn, *a, trace_wide=trace_wide)(*a, rules=rules)

    sparse = nls.NewtonRaphson(autodiff=nls.JacobianPolicy(mode="sparse"))
    prob = bratu.make_problem(args.n, dtype=torch.float32, device=dev)
    sol = nls.solve(prob, sparse, abstol=1e-2, maxiters=50)
    kw = {"rounds": 4, "restart": 32, "krylov_maxiter": 400}
    roots = {}
    order = []
    for i in range(args.pairs):
        order += (["once", "per_defect"] if i % 2 == 0
                  else ["per_defect", "once"])
    for variant in order:
        dfe.df_trace = real_df_trace if variant == "once" else per_defect
        traces[0] = 0
        _sync(dev)
        t0 = time.perf_counter()
        res = nls.auto_refine(prob, sol.u, **kw)
        _sync(dev)
        wall = time.perf_counter() - t0
        u = res.u.hi.double() + res.u.lo.double()
        other = roots.get("per_defect" if variant == "once" else "once")
        roots[variant] = u
        print(json.dumps({
            "case": "auto_refine", "N": args.n, "variant": variant,
            "device": str(dev), "wall_s": wall, "traces": traces[0],
            "defect_inf": float(res.defect_norm),
            "rel_inf_to_other_variant": (
                None if other is None else
                float((u - other).abs().max() / u.abs().max()))}),
            flush=True)
    dfe.df_trace = real_df_trace
    # one trace (narrow and wide) and one evaluation of the graph alone
    u_df = DF(sol.u, torch.zeros_like(sol.u))
    fn, p = prob.f.f, DF(prob.p, torch.zeros_like(prob.p))
    _sync(dev)
    t0 = time.perf_counter()
    graph = dfe.df_trace(fn, u_df, p)
    _sync(dev)
    t_trace = time.perf_counter() - t0
    graph(u_df, p)
    _sync(dev)
    t0 = time.perf_counter()
    graph(u_df, p)
    _sync(dev)
    print(json.dumps({"case": "parts", "N": args.n, "device": str(dev),
                      "trace_s": t_trace,
                      "warm_eval_s": time.perf_counter() - t0}), flush=True)
    _graph.trace = real_trace


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the 3D reaction–diffusion path of one checkout of the port on the
card, for a side-by-side of two commits in one call.

    python3 tools/rd3d_ab.py ROOT

imports ``nonlinearsolve_tpu_torch`` from the checkout at ROOT (building
its kernels there) and prints one JSON line: the card's name and power
limit (as nvidia-smi gives them), the step of the chained, normalised
matvec at 256³ f32 (K10, bz 8, the scale kept on the device: ``chip_smoke.py``
phase 9's chain) by CUDA events over 100 steps replayed 4 times from a
CUDA graph, K10 alone the same way, and five warm walls of the 3D solve at
the example's operating point (phase 10: Newton–GMRES(8) with the FFT
preconditioner, η = 0.1, abstol 1e-5·N, K9 in every Krylov iteration),
each between two ``torch.cuda.synchronize()``.  Run it on two checkouts
in turns (parent, change, change, parent) in one call to compare them on
one card.  Needs one CUDA device; exits non-zero without one.
"""

import json
import os
import subprocess
import sys
import time


def graph_ms(torch, fn, calls=100, replays=4):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def main(root):
    import torch
    if not torch.cuda.is_available():
        print("rd3d_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(root))
    import nonlinearsolve_tpu_torch as nls
    from nonlinearsolve_tpu_torch.models import reaction_diffusion
    from nonlinearsolve_tpu_torch.ops import stencil3d
    from nonlinearsolve_tpu_torch.ops.preconditioners import (
        fft_poisson_preconditioner)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    N, f32 = 256, torch.float32
    prob = reaction_diffusion.make_problem(N, dtype=f32, kernel_jvp=True)
    u, D = prob.u0, prob.p[0]
    carry = {"c": torch.ones_like(u),
             "s": torch.ones((), dtype=f32, device=u.device)}

    def step():
        carry["c"], m = stencil3d.rd3d_jvp_scaled(u, carry["c"], D,
                                                  1.0 / carry["s"], bz=8)
        carry["s"] = torch.clamp(m, min=1.0)

    t = torch.randn(u.shape, generator=torch.Generator(
        device=u.device).manual_seed(3), dtype=f32, device=u.device)
    inv = torch.tensor(0.5, dtype=f32, device=u.device)
    k10_ms = graph_ms(torch, lambda: stencil3d.rd3d_jvp_scaled(
        u, t, D, inv, bz=8))
    chain_ms = graph_ms(torch, step)
    pm = fft_poisson_preconditioner((N, N, N), 0.01, 1.0 / N, shift=-0.9)
    alg = nls.NewtonRaphson(
        linsolve=nls.LinearSolver(method="gmres", restart=8,
                                  krylov_maxiter=200, precond_fn=pm),
        forcing=nls.EisenstatWalkerForcing(eta_0=0.1, eta_max=0.1))
    walls, nsteps = [], None
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = nls.solve(prob, alg, abstol=1e-5 * N, maxiters=30)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        nsteps = int(sol.stats.nsteps)
        if sol.retcode != nls.ReturnCode.Success:
            raise AssertionError(f"3D solve: {sol.retcode.name}")
    walls = walls[1:]                       # the first builds the plans
    print(json.dumps({
        "root": root, "nvidia_smi": smi, "k10_ms": k10_ms,
        "chain_step_ms": chain_ms, "solve_warm_s": walls,
        "solve_warm_s_median": sorted(walls)[len(walls) // 2],
        "nsteps": nsteps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))

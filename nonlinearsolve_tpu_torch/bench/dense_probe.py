"""Time the dense solver surface's building blocks on the card.

    python3 nonlinearsolve_tpu_torch/bench/dense_probe.py

Prints one JSON line per measurement (CUDA-event times, median of 5 after
a warm-up) with the card's name and power limit: the forward-mode
Jacobian of the Brusselator at N=32 and N=64 (2048 and 8192 unknowns),
the LU solve (``solve_dense``, cuSOLVER getrf/getrs) at both sizes, the
SVD least squares of LevenbergMarquardt's stacked system at N=32
(4096×2048) with torch's default SVD driver and with each named one,
Gauss–Jordan on a 10×10 system (the small-system route of the 23
problems: a CUDA graph of about 140 small kernels), and 20 steps of
NewtonRaphson, TrustRegion and LevenbergMarquardt on a 23-problem start,
host syncs included.  Needs one
CUDA device.
"""

import json
import os
import subprocess
import sys
import time


def main():
    import torch
    if not torch.cuda.is_available():
        print("dense_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
    import nonlinearsolve_tpu_torch as nls
    from nonlinearsolve_tpu_torch.core.descent import DescentCtx
    from nonlinearsolve_tpu_torch.core.jacobian import construct_jacobian
    from nonlinearsolve_tpu_torch.models import brusselator
    from nonlinearsolve_tpu_torch.models.problems23 import PROBLEMS_23
    from nonlinearsolve_tpu_torch.ops import linear_solve as ls

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    def timed(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append((a.elapsed_time(b), (time.perf_counter() - t0) * 1e3))
        out.sort()
        return {"event_ms": out[len(out) // 2][0],
                "wall_ms": out[len(out) // 2][1]}

    def emit(rec):
        rec["card"] = smi
        print(json.dumps(rec), flush=True)

    f64 = torch.float64
    for N in (32, 64):
        prob = brusselator.make_problem(N, f64)
        ctx = DescentCtx(f_flat=lambda u, p=prob.p: brusselator.brusselator_2d(
            u, p), n_in=prob.u0.numel(), n_out=prob.u0.numel())
        jac = construct_jacobian(nls.JacobianPolicy(), None, ctx, None)[0]
        with torch.no_grad():
            J = jac(prob.u0)
            emit({"what": "jacfwd", "N": N, "n": J.shape[0],
                  **timed(lambda: jac(prob.u0))})
            b = brusselator.brusselator_2d(prob.u0, prob.p).reshape(-1)
            emit({"what": "solve_dense_lu", "n": J.shape[0],
                  **timed(lambda: ls.solve_dense(J, b))})
            if N == 32:
                A = torch.cat([J, torch.eye(J.shape[0], dtype=f64,
                                            device=J.device)])
                rhs = torch.cat([b, torch.zeros_like(b)])
                x0 = ls._lstsq(A, rhs)[0]
                emit({"what": "lstsq_svd", "shape": list(A.shape),
                      **timed(lambda: ls._lstsq(A, rhs), reps=3)})
                for driver in ("gesvd", "gesvdj", "gesvda"):
                    f = torch.linalg.svd(A, full_matrices=False,
                                         driver=driver)
                    x = ls._lstsq(A, rhs, f)[0]
                    emit({"what": "svd_driver", "driver": driver,
                          "x_rel_diff_to_default": float(
                              (x - x0).abs().max() / x0.abs().max()),
                          **timed(lambda: torch.linalg.svd(
                              A, full_matrices=False, driver=driver),
                              reps=3)})
            del J
    g = torch.Generator().manual_seed(0)
    A = torch.randn(10, 10, generator=g, dtype=f64).cuda()
    b = torch.randn(10, generator=g, dtype=f64).cuda()
    emit({"what": "gauss_jordan_10", **timed(
        lambda: ls.gauss_jordan_solve(A, b))})
    tp = PROBLEMS_23[10]
    prob = nls.NonlinearProblem(tp.f, torch.tensor(tp.start, device="cuda"))
    for name, alg in (("NewtonRaphson", nls.NewtonRaphson()),
                      ("TrustRegion", nls.TrustRegion()),
                      ("LevenbergMarquardt", nls.LevenbergMarquardt())):
        t = timed(lambda: nls.solve(prob, alg, maxiters=20,
                                    abstol=0.0), reps=3)
        emit({"what": "23_problem_20_steps", "alg": name,
              "ms_per_step": t["wall_ms"] / 20})
    return 0


if __name__ == "__main__":
    sys.exit(main())

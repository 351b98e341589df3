"""Per-step trace of LevenbergMarquardt on u³ − 8 from −0.8 + 1.5i
(complex128, the default abstol) in the PyTorch port, on the CPU and, when
one is present, on the CUDA device.

For each device and each way of writing the cube (``u ** 3``, which torch
evaluates through its complex ``pow``, and ``u * u * u``, the JAX
package's ``integer_pow``), it prints one JSON line with the retcode, the
NLStats and, for every step, ‖F(u)‖, λ, ‖v‖, ‖a‖, the geodesic test
(2‖a‖ ≤ α‖v‖) and the uphill test.  Then it compares, on seeded complex128
points near the root, torch's ``z ** 3`` on each device with ``z * z * z``
on the CPU, and the SVD least-squares solves of the stacked damped systems
[J; √D] that the device run factored, on the device (each SVD driver) and
on the CPU.

    python3 tools/complex_lm_trace.py            # CPU, and CUDA if present
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import nonlinearsolve_tpu_torch as tnls                      # noqa: E402
from nonlinearsolve_tpu_torch.core import descent as dsc     # noqa: E402
from nonlinearsolve_tpu_torch.core import trust_region as trg  # noqa: E402
from nonlinearsolve_tpu_torch.utils.norms import l2_norm     # noqa: E402

RESIDUALS = {"pow": lambda u, p: u ** 3 - p,
             "mul": lambda u, p: u * u * u - p}


def _traced_run(dev, form):
    steps, systems = [], []
    cur = {}
    orig_geo, orig_tr, orig_lstsq = (dsc._geodesic_solve,
                                     trg._lm_tr_update, dsc._lstsq)

    def geo(cfg, state, ctx, J, fu, u, trust_region):
        # _geodesic_solve step for step, recording the norms it compares
        h = cfg.finite_diff_step
        res_v, state = dsc.descent_solve(cfg.descent, state, ctx, J, fu, u,
                                         trust_region=trust_region,
                                         recompute_damping=True)
        v = res_v.du
        fu2 = ctx.f_flat(torch.add(u, v, alpha=h))
        rhs = (2.0 / h) * ((fu2 - fu) / h - dsc.mv(J, v))
        res_a, state = dsc.descent_solve(cfg.descent, state, ctx, J, rhs, u,
                                         trust_region=trust_region,
                                         recompute_damping=False)
        a = res_a.du
        accepted = 2.0 * l2_norm(a) <= cfg.alpha * l2_norm(v)
        cur.update(F=float(l2_norm(fu)), v=float(l2_norm(v)),
                   a=float(l2_norm(a)),
                   lam=complex(state.damping.lam).real)
        du = torch.where(accepted, v + a / 2.0, v)
        ok = res_v.linsolve_success & res_a.linsolve_success
        return dsc.DescentResult(
            du=du, success=accepted & ok, linsolve_success=ok,
            duJtJdu=dsc._nan_like(du), v=v, nf=res_v.nf + res_a.nf + 1,
            nsolve=res_v.nsolve + res_a.nsolve,
            nfactors=res_v.nfactors), state

    def lstsq(A, b, factors=None):
        if factors is None:
            systems.append((A.detach().cpu().clone(), b.detach().cpu().clone()))
        return orig_lstsq(A, b, factors)

    def tr(cfg, state, host, descent_result, du):
        acc, st = orig_tr(cfg, state, host, descent_result, du)
        cur.update(geo_ok=bool(descent_result.success), tr_ok=acc,
                   loss=abs(complex(host[2])))
        steps.append(dict(cur))
        return acc, st

    dsc._geodesic_solve, trg._lm_tr_update, dsc._lstsq = geo, tr, lstsq
    try:
        sol = tnls.solve(tnls.NonlinearProblem(
            RESIDUALS[form],
            torch.tensor([-0.8 + 1.5j], dtype=torch.complex128, device=dev),
            8.0), tnls.LevenbergMarquardt())
    finally:
        dsc._geodesic_solve, trg._lm_tr_update, dsc._lstsq = (
            orig_geo, orig_tr, orig_lstsq)
    s = sol.stats
    return sol, [int(s.nf), int(s.njacs), int(s.nfactors), int(s.nsolve),
                 int(s.nsteps)], steps, systems


def main():
    torch.set_num_threads(1)
    devs = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    roots, card_systems = {}, []
    for dev in devs:
        for form in RESIDUALS:
            sol, stats, steps, systems = _traced_run(dev, form)
            roots[(dev, form)] = sol.u.detach().cpu()
            if dev == "cuda" and form == "pow":
                card_systems = systems
            print(json.dumps({
                "case": "lm_cubic", "device": dev, "cube": form,
                "retcode": sol.retcode.name, "stats": stats,
                "u": [complex(sol.u[0]).real, complex(sol.u[0]).imag],
                "steps": [[k, st["F"], st["lam"], st["v"], st["a"],
                           int(st["geo_ok"]), int(st["tr_ok"])]
                          for k, st in enumerate(steps)]}), flush=True)
    # the cube's rounding: torch's z ** 3 and z * z * z on each device
    # against z * z * z on the CPU, at seeded points within 1e-6 of the
    # root, and F at the CPU's root
    rng = np.random.default_rng(0)
    root = complex(roots[("cpu", "mul")][0])
    z = root + 1e-6 * (rng.standard_normal(1 << 16)
                       + 1j * rng.standard_normal(1 << 16))
    zc = torch.as_tensor(z)
    ref = zc * zc * zc
    for dev in devs:
        zd = zc.to(dev)
        for form, val in (("pow", zd ** 3), ("mul", zd * zd * zd)):
            err = (val.cpu() - ref).abs()
            r = torch.tensor([root], dtype=torch.complex128, device=dev)
            print(json.dumps({
                "case": "cube_rounding", "device": dev, "cube": form,
                "points": int(zc.numel()),
                "max_abs_dev_from_cpu_mul": float(err.max()),
                "mean_abs_dev_from_cpu_mul": float(err.mean()),
                "abs_F_at_cpu_root": float(
                    RESIDUALS[form](r, 8.0).abs().max())}), flush=True)
    # the card's SVD least squares on the systems it factored, against the
    # CPU's, with every driver cuSOLVER offers
    if card_systems:
        worst = {}
        for A, b in card_systems:
            xc, _ = dsc._lstsq(A, b)
            scale = float(xc.abs().max()) or 1.0
            for drv in (None, "gesvd", "gesvdj", "gesvda"):
                Ad = A.cuda()
                U, S, Vh = torch.linalg.svd(Ad, full_matrices=False,
                                            driver=drv)
                xd, _ = dsc._lstsq(Ad, b.cuda(), (U, S, Vh))
                rel = float((xd.cpu() - xc).abs().max()) / scale
                worst[str(drv)] = max(worst.get(str(drv), 0.0), rel)
        print(json.dumps({"case": "svd_lstsq", "systems": len(card_systems),
                          "max_rel_dev_from_cpu": worst}), flush=True)


if __name__ == "__main__":
    main()

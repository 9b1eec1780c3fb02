"""``path``: a closed loop of lambda sweeps through ``api.solve_path``.

Call i sweeps the pool's dataset i mod P over the traffic's lambdas at a
fixed budget: one warm solve of ``warm_iters`` at ``warm_lam`` shared by
every lambda, then ``final_iters`` with a lane a lambda, and copies
every lane's weights to the host.
"""
from __future__ import annotations

import time

import numpy as np

from perfbench.bench import range_of
from perfbench.ref.alg1 import max_gap

CHECK_READS = ("lams",)


def lams(traffic: dict) -> list[float]:
    lo, hi, count = traffic["lams_geomspace"]
    return [float(v) for v in np.geomspace(lo, hi, int(count))
            .astype(np.float32)]


def setup(ctx):
    cfg = ctx.solver_config(
        metric_every=ctx.traffic["metric_every"], tol=None,
        warm_lam=ctx.traffic["warm_lam"],
        warm_iters=ctx.traffic["warm_iters"],
        final_iters=ctx.traffic["final_iters"])
    problems = [ctx.problem(ctx.dataset(p))
                for p in range(len(ctx.states))]
    st = {"cfg": cfg, "problems": problems, "lams": lams(ctx.traffic)}
    sweep(st, 0)
    return st


def sweep(st, p: int):
    from repro_torch.api import solve_path

    with range_of("solve_path"):
        r = solve_path(st["problems"][p], st["lams"], st["cfg"])
    with range_of("weights_to_host"):
        return r.w.cpu()


def call(ctx, st, i: int) -> dict:
    p = i % len(st["problems"])
    t0 = time.perf_counter()
    w = sweep(st, p)
    seconds = time.perf_counter() - t0
    ctx.sampler.offer(i, lambda: w)
    t = ctx.traffic
    return {"pool": p, "seconds": seconds, "met": True,
            "one_lane_iterations": t["warm_iters"],
            "lane_step_iterations": t["final_iters"],
            "lanes": len(st["lams"])}


def end_to_end(records: list, window_s: float) -> dict:
    return {"sweep_s": window_s / len(records)}


def check(ctx, st, records: list) -> dict:
    """Each kept sweep from zeros: the warm solve at ``warm_lam``, then
    every lambda from the warm weights and the warm duals clipped to its
    own box, all lanes at once."""
    t = ctx.traffic
    gaps = []
    for i, w in sorted(ctx.sampler.items.items()):
        ds = ctx.dataset(records[i]["pool"])
        warm = ctx.reference(ds, lam=t["warm_lam"])
        w0, u0 = warm.zeros(ctx.features)
        w0, u0, _ = warm.block(w0, u0, t["warm_iters"])
        del warm
        lanes = ctx.reference(ds, lam=st["lams"])
        wl = w0.expand((len(st["lams"]),) + tuple(w0.shape)).clone()
        ul = lanes.clip(u0.expand((len(st["lams"]),) + tuple(u0.shape)))
        wl, _, _ = lanes.block(wl, ul, t["final_iters"])
        gaps.append(max_gap(w, wl))
        del lanes
    return {"w_gap": max(gaps)}

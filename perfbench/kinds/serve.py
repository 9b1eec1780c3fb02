"""``serve``: one tenant session of a ``SolveService`` and one closed-loop
client re-fitting as its local data drifts.

Set-up admits the pool's first dataset, answers a cold request and one
warm request.  Each timed request hands over new targets for a share of
the labeled nodes (``update_session`` with a ``DataDelta``), asks for a
warm solve to tol and copies the weights to the host; its latency runs
from the hand-over to the weights on the host.  A response that does not
meet tol has failed.

The reference replays the session: the cold solve and the first
``replayed`` requests from its own state, each warm start the previous
answer with its duals clipped to the box, as the service's.  Later
requests, a seeded sample of ``sampled`` of them, it follows from the
program's own state before the request (a replay of hundreds of warm
solves would outlast the window).
"""
from __future__ import annotations

import math
import time

import torch

from perfbench.bench import range_of
from perfbench.data import Drift
from perfbench.ref.alg1 import max_gap, solve_to_stop

#: the service loads the saved plans itself (``load_plans``)
LOADS_PLANS = True

CHECK_READS = ("history", "replayed", "cold_w", "cold_iterations",
               "warm_up", "warm_up_w")


def setup(ctx):
    from repro_torch.serving import DataDelta, SolveService

    cfg = ctx.solver_config()
    svc = SolveService(config=cfg)
    t0 = time.perf_counter()
    svc.load_plans(ctx.plans_dir, device=ctx.device)
    ctx.load_plans_s = time.perf_counter() - t0
    ds = ctx.dataset(0)
    sid = svc.create_session("bench", ctx.problem(ds, plan=False))
    cold = svc.solve(sid)
    drift = Drift(ctx.config, ds, ctx.w_true, ctx.seed,
                  fraction=ctx.traffic["drift_fraction"],
                  noise=ctx.traffic["drift_noise"])
    st = {"svc": svc, "sid": sid, "drift": drift, "DataDelta": DataDelta,
          "history": [], "replayed": {}, "cold_w": cold.w.cpu(),
          "cold_iterations": cold.iterations}
    # one warm request: the update and warm paths loaded before the window
    warm = request(st)
    st["warm_up_w"] = warm.pop("w")
    warm.pop("before")
    st["warm_up"] = warm
    return st


def request(st) -> dict:
    """One request: new targets handed over, a warm solve, the weights
    on the host."""
    svc, sid = st["svc"], st["sid"]
    nodes, rows = st["drift"].next()
    st["history"].append((nodes, rows))
    sess = svc.session(sid)
    before = (sess.w, sess.u)
    delta = st["DataDelta"](nodes=tuple(int(v) for v in nodes), y=rows)
    t0 = time.perf_counter()
    with range_of("service.update_session"):
        svc.update_session(sid, delta=delta)
    with range_of("service.solve"):
        resp = svc.solve(sid)
    with range_of("weights_to_host"):
        w = resp.w.cpu()
    seconds = time.perf_counter() - t0
    return {"seconds": seconds, "solve_seconds": resp.solve_seconds,
            "iterations": resp.iterations, "met": bool(resp.meets_sla),
            "w": w, "before": before, "request": len(st["history"]) - 1}


def call(ctx, st, i: int) -> dict:
    rec = request(st)
    w, before = rec.pop("w"), rec.pop("before")
    if i < int(ctx.traffic["replayed"]):
        st["replayed"][i] = w
    else:
        ctx.sampler.offer(i, lambda: (w, before))
    return rec


def end_to_end(records: list, window_s: float) -> dict:
    lat = sorted(r["seconds"] for r in records)
    return {"request_p90_ms": 1e3 * nearest_rank(lat, 0.90)}


def notes(records: list) -> dict:
    """The tail's sample: requests in the window, and how many lie
    beyond the 90th percentile."""
    return {"requests": len(records),
            "beyond_p90": beyond(len(records), 0.90)}


def nearest_rank(sorted_values: list, q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least
    a share q of the values at or below it."""
    k = max(int(math.ceil(q * len(sorted_values))), 1)
    return sorted_values[k - 1]


def beyond(count: int, q: float) -> int:
    """How many of ``count`` values lie beyond the nearest-rank
    q-quantile."""
    return count - max(int(math.ceil(q * count)), 1)


def _data_at(ctx, st, request: int):
    """The session's dataset after drift events 0..``request`` (the
    warm-up's is event 0), from the benchmark's own history."""
    ds = ctx.dataset(0)
    y = ds.y.clone()
    for nodes, rows in st["history"][:request + 1]:
        idx = torch.from_numpy(nodes).to(y.device)
        y[idx] = torch.from_numpy(rows).to(y.device)
    return type(ds)(x=ds.x, y=y, labeled=ds.labeled)


def check(ctx, st, records: list) -> dict:
    gaps = []
    follow = dict(tol=ctx.tol, metric_every=ctx.metric_every,
                  budget=ctx.budget)
    # the start: the cold answer from zeros on the admitted data
    alg = ctx.reference(ctx.dataset(0))
    w, u, _, _ = solve_to_stop(alg, *alg.zeros(ctx.features),
                               program_iters=st["cold_iterations"], **follow)
    gaps.append(max_gap(st["cold_w"], w))
    del alg
    # the warm-up and the first requests, each from the reference's own
    # previous answer
    chain = [(st["warm_up"], st["warm_up_w"])] + [
        (records[i], st["replayed"][i]) for i in sorted(st["replayed"])]
    for rec, w_prog in chain:
        alg = ctx.reference(_data_at(ctx, st, rec["request"]))
        w, u, _, _ = solve_to_stop(alg, w, alg.clip(u),
                                   program_iters=rec["iterations"], **follow)
        gaps.append(max_gap(w_prog, w))
        del alg
    # a sample of later requests, from the program's state before each
    for i, (w_prog, (w_b, u_b)) in sorted(ctx.sampler.items.items()):
        rec = records[i]
        alg = ctx.reference(_data_at(ctx, st, rec["request"]))
        w, _, _, _ = solve_to_stop(
            alg, w_b.to(alg.dtype), alg.clip(u_b.to(alg.dtype)),
            program_iters=rec["iterations"], **follow)
        gaps.append(max_gap(w_prog, w))
        del alg
    return {"w_gap": max(gaps)}

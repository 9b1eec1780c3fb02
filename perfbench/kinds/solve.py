"""``solve``: a closed loop of tol solves through ``Solver.run``.

Call i draws the pool's dataset i mod P on the device (the data handed
over; the run holds no other dataset) and solves it as a new ``Problem``
on the same graph object (its plan attached), from zeros to the
configuration's tol or budget, and copies the weights to the host.  A
solve that spends its budget without meeting tol has failed.
"""
from __future__ import annotations

import time

from perfbench.bench import range_of
from perfbench.ref.alg1 import max_gap, solve_to_stop

#: what ``check`` reads of the state once the program's objects are gone
CHECK_READS = ()


def setup(ctx):
    from repro_torch.api import Solver

    solver = Solver(ctx.solver_config())
    # warm-up at the cell's shapes: a draw and a whole solve, its graph
    # captured
    solver.run(ctx.problem(ctx.dataset(0))).w.cpu()
    return {"solver": solver}


def call(ctx, st, i: int) -> dict:
    p = i % len(ctx.states)
    with range_of("bench.draw_dataset"):
        problem = ctx.problem(ctx.dataset(p))
    t0 = time.perf_counter()
    with range_of("solver.run"):
        r = st["solver"].run(problem)
    with range_of("weights_to_host"):
        w = r.w.cpu()
    seconds = time.perf_counter() - t0
    iters = int(r.diagnostics["iterations"])
    met = iters < ctx.budget or float(r.residual[-1]) <= ctx.tol
    ctx.sampler.offer(i, lambda: w)
    return {"pool": p, "seconds": seconds, "iterations": iters,
            "met": met}


def end_to_end(records: list, window_s: float) -> dict:
    return {"solve_s": window_s / len(records)}


def check(ctx, st, records: list) -> dict:
    gaps = []
    for i, w in sorted(ctx.sampler.items.items()):
        rec = records[i]
        alg = ctx.reference(ctx.dataset(rec["pool"]))
        w0, u0 = alg.zeros(ctx.features)
        target, _, _, _ = solve_to_stop(
            alg, w0, u0, program_iters=rec["iterations"], tol=ctx.tol,
            metric_every=ctx.metric_every, budget=ctx.budget)
        gaps.append(max_gap(w, target))
        del alg
    return {"w_gap": max(gaps)}


"""Serving walkthrough (PyTorch port): a live GTVMin session under an
update stream.

Walks the port's solve service through its whole surface on one
scenario:

  1. admit a Problem as a session and cold-solve it (the plan is built
     here, once),
  2. stream per-node data deltas at it — each warm re-solve re-certifies
     (eq.-11 residual <= tol) in a fraction of the cold iterations,
  3. patch the graph structure (drop + add an edge) — the cached duals
     survive the edge relabeling and the plan cache re-plans,
  4. a second tenant with the same graph structure shares the plan
     (cache hit),
  5. sweep a lambda path against the session without disturbing its
     warm state, and read the per-tenant service ledgers,
  6. queue shape-matched sessions and flush them as ONE batched solve
     (the multi-tenant fast path),
  7. save the plan cache and restart the service: the new service loads
     the plans (structure-hash-validated) and re-plans nothing.

    python examples/serving_stream_torch.py               # CUDA card
    python examples/serving_stream_torch.py --device cpu  # on the CPU
    REPRO_SMOKE=1 python examples/serving_stream_torch.py # CI-sized
"""
import argparse
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np                                             # noqa: E402
import torch                                                   # noqa: E402

from repro_torch.device import to_host                         # noqa: E402
from repro_torch.scenarios import get_scenario                 # noqa: E402
from repro_torch.serving import (EdgePatch, ServingQueue,     # noqa: E402
                                 SolveService, latency_stats, replay,
                                 synthetic_stream)

LAM = 1e-2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    smoke = bool(os.environ.get("REPRO_SMOKE"))
    steps = 4 if smoke else 12

    # 1. admit a session: the first solve pays the plan build
    inst = get_scenario("sbm_regression").build(seed=0, smoke=smoke,
                                                device=args.device)
    problem = inst.problem.with_lam(LAM)
    g = problem.graph
    print(f"empirical graph: |V|={g.num_nodes} |E|={g.num_edges} "
          f"structure={g.structure_hash()[:12]}")

    svc = SolveService()
    sid = svc.create_session("acme", problem)
    cold = svc.solve(sid)
    print(f"cold solve: {cold.iterations} iters, residual "
          f"{cold.residual:.1e} <= tol {cold.tol} "
          f"(meets_sla={cold.meets_sla}), {cold.seconds:.2f}s incl. plan")

    # 2. stream small data deltas: warm re-solves re-certify cheaply
    rng = np.random.default_rng(1)
    events = synthetic_stream(rng, problem.data, problem.graph,
                              num_steps=steps, drift_fraction=0.05,
                              drift_scale=0.05)
    records = replay(svc, sid, events)
    stats = latency_stats(records)
    iters = [r["warm_iterations"] for r in records]
    print(f"{steps}-step drift stream: warm iters {min(iters)}..{max(iters)}"
          f" (cold was {cold.iterations}), p50 latency "
          f"{stats['p50'] * 1e3:.1f}ms")
    if not all(r["warm_meets_sla"] for r in records):
        raise SystemExit("every response must certify")
    if max(iters) > cold.iterations:
        raise SystemExit("a warm solve must never exceed the cold one")

    # 3. structural update: drop one edge, add a non-edge; duals transfer
    src, dst = to_host(g.src), to_host(g.dst)
    i, j = int(src[0]), int(dst[0])
    a, b = 1, g.num_nodes - 2
    svc.update_session(sid, patch=EdgePatch(drop=((i, j),),
                                            add=((a, b, 1.0),)))
    patched = svc.solve(sid)
    print(f"edge patch (-{{{i},{j}}} +{{{a},{b}}}): {patched.iterations} "
          f"iters (cache_hit={patched.cache_hit}: new structure hash "
          f"re-plans)")

    # 4. a second tenant, same structure, different data: plan is shared
    inst_b = get_scenario("sbm_regression").build(seed=0, smoke=smoke,
                                                  device=args.device)
    sid_b = svc.create_session("globex", inst_b.problem.with_lam(LAM))
    resp_b = svc.solve(sid_b)
    print(f"tenant 'globex', same structure: cache_hit={resp_b.cache_hit}, "
          f"compiled={resp_b.compiled} (plan shared across tenants)")

    # 5. read-only lambda sweep + the per-tenant ledgers
    path = svc.solve_path(sid_b, [LAM / 2, LAM, LAM * 2])
    print("lambda path objectives: "
          + ", ".join(f"{p.lam:.3g}->{p.objective:.3f}" for p in path))

    for tenant in ("acme", "globex"):
        s = svc.ledger(tenant).summary()
        print(f"ledger[{tenant}]: requests={s['requests']:.0f} "
              f"solves={s['solves']:.0f} hit_rate={s['cache_hit_rate']:.2f} "
              f"compiles={s['compiles']:.0f} "
              f"warm_ratio={s['warm_iteration_ratio']:.3f}")
    cache = svc.plans.summary()
    print(f"plan cache: {cache['entries']:.0f} entries, "
          f"{cache['compiled_sigs']:.0f} compiled signature(s)")

    # 6. batched serving: queue shape-matched sessions, flush as one
    # batched solve.  Same graph + shapes => same exec sig => the requests
    # stack into one solve over a lane axis; each response keeps its own
    # certificate.
    y0 = to_host(problem.data.y)
    batch_sids = []
    for k in range(4):
        rng_k = np.random.default_rng(100 + k)
        y = y0 + 0.05 * np.std(y0) * rng_k.standard_normal(
            y0.shape).astype(np.float32)
        p_k = dataclasses.replace(problem, data=dataclasses.replace(
            problem.data, y=torch.as_tensor(y, device=problem.device)))
        batch_sids.append(svc.create_session(f"fleet_{k}", p_k))

    queue = ServingQueue(svc, max_batch=4, max_wait_requests=16)
    tickets = [queue.submit(s) for s in batch_sids]   # 4th submit flushes
    if not all(t is not None and t.done for t in tickets):
        raise SystemExit("the fourth submit must flush the queue")
    q = queue.stats()
    print(f"queued flush: {q['flushes']:.0f} flush served "
          f"{q['batched']:.0f} requests as one batched solve "
          f"(certified={all(t.response.meets_sla for t in tickets)})")

    # 7. plan persistence: a restarted service skips re-planning entirely
    with tempfile.TemporaryDirectory() as tmp:
        plans_dir = os.path.join(tmp, "plans")
        saved = svc.save_plans(plans_dir)
        restarted = SolveService()                    # fresh service
        restarted.load_plans(plans_dir, device=problem.device)
        rsid = restarted.create_session("acme", problem)
        r = restarted.solve(rsid)
        print(f"restart: loaded {saved['plans']} plans, solve was "
              f"cache_hit={r.cache_hit} with {restarted.plans.misses:.0f} "
              f"re-plans (compiled={r.compiled})")
        if restarted.plans.misses != 0:
            raise SystemExit("a restarted service must re-plan nothing")
    return 0


if __name__ == "__main__":
    sys.exit(main())

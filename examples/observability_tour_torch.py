"""Tour of repro_torch.obs (PyTorch port): metrics, request events,
snapshots, profiles.

Runs the whole telemetry surface end to end with observability ON:

  1. direct tol solves (``Solver``) — transfer + solve counters, spans,
  2. a multi-tenant serving stream through the admission queue — one
     JSONL event per response (queue wait, batch width, cache and
     compile outcomes, the compile/execute timing split),
  3. a lambda-path sweep (``solve_path`` events),
  4. a federated run — CommLedger wire bytes exported to the registry,
  5. JSON + Prometheus snapshots, both self-validated, plus an optional
     ``torch.profiler`` trace of one solve (``--profile``, through
     ``obs.profile.trace``).

Artifacts land in ``--out`` (default ``results/obs``):
``events.jsonl``, ``metrics.json``, ``metrics.prom``.

Run:  REPRO_SOLVER_MAX_ITERS=4000 python examples/observability_tour_torch.py
      (``--device cpu`` runs it on the CPU; the default is the CUDA card)
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.api import Solver, SolverConfig  # noqa: E402
from repro_torch.federated import FederatedConfig, run_federated  # noqa: E402
from repro_torch.obs.events import validate_jsonl  # noqa: E402
from repro_torch.obs.export import validate_prometheus  # noqa: E402
from repro_torch.scenarios import get_scenario  # noqa: E402
from repro_torch.serving import ServingQueue, SolveService  # noqa: E402
from repro_torch.serving import synthetic_stream  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=os.path.join("results", "obs"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also capture a torch.profiler trace of one solve")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    # -- 1. switch telemetry on and attach the event sink -------------------
    obs.enable()                 # equivalently: REPRO_OBS=1 in the env
    obs.reset()                  # fresh registry + event log for the tour
    obs.enable()
    events_path = os.path.join(args.out, "events.jsonl")
    if os.path.exists(events_path):
        os.remove(events_path)
    obs.events.attach(events_path)

    inst = get_scenario("sbm_regression").build(seed=args.seed, smoke=True,
                                                device=args.device)
    problem = inst.problem.with_lam(1e-2)

    # -- 2. direct solves: spans, solve + transfer counters -----------------
    cfg = SolverConfig(num_iters=2000, rho=1.9, metric_every=25, tol=1e-3,
                       record_residual=True)
    with obs.span("tour_direct_solve"):
        result = Solver(cfg).run(problem)
    print(f"direct solve: {result.diagnostics.get('iterations')} iters, "
          f"residual {float(result.residual[-1]):.2e}")
    transfers = obs.counter("repro_transfers_device_to_host_total")
    print(f"device->host transfers so far: {transfers.value:.0f}")

    # -- 3. a serving stream through the admission queue --------------------
    service = SolveService(cfg.replace(backend="dense"))
    rng = np.random.default_rng(args.seed)
    sids = [service.create_session(f"tenant_{i % 2}", problem)
            for i in range(3)]
    queue = ServingQueue(service, max_batch=4, max_wait_requests=8)
    for sid in sids:                       # cold round: plans metered
        queue.submit(sid)
    queue.drain()
    for ev in synthetic_stream(rng, problem.data, problem.graph,
                               num_steps=3, drift_fraction=0.05,
                               drift_scale=0.05, churn_every=0):
        for sid in sids:                   # warm rounds through the queue
            service.update_session(sid, delta=ev.delta)
            queue.submit(sid)
        queue.drain()
    service.solve_path(sids[0], [1e-1, 1e-2])
    print(f"serving: {len(obs.events.LOG.recent())} request events, "
          f"rolling latency {obs.events.rolling_latency()}")

    # -- 4. a federated run: wire bytes into the registry -------------------
    run_federated(problem, FederatedConfig(
        num_rounds=60, metric_every=10, participation="bernoulli",
        compression="int8", seed=args.seed))
    fed_bytes = obs.counter("repro_federated_up_bytes_total").value
    print(f"federated: {fed_bytes:.0f} upstream bytes metered")

    # -- 5. snapshots + validation ------------------------------------------
    json_path = os.path.join(args.out, "metrics.json")
    prom_path = os.path.join(args.out, "metrics.prom")
    snap_text = obs.export.export_json(json_path)
    prom_text = obs.export.export_prometheus(prom_path)

    n_events = validate_jsonl(events_path)
    series = validate_prometheus(prom_text)
    snap = json.loads(snap_text)
    names = {m["name"] for m in snap["metrics"]}
    missing = sorted(names - set(series))
    if missing:
        raise SystemExit(f"prometheus export missing metrics: {missing}")
    print(f"validated {n_events} events and {len(series)} metric series")
    print(f"wrote {events_path}, {json_path}, {prom_path}")

    # -- 6. optional device profile -----------------------------------------
    if args.profile:
        logdir = os.path.join(args.out, "profile")
        with obs.profile.trace(logdir):
            Solver(cfg).run(problem)
        print(f"trace in {os.path.join(logdir, 'trace.json')} (view: "
              f"chrome://tracing or Perfetto; phases appear as alg1_* "
              f"ranges)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

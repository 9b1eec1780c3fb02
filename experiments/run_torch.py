"""Experiment harness (PyTorch port): sweep scenarios x backends x lambda,
emit a report.

The port's copy of ``experiments/run.py``: the same modes, flags, CSV
fields and report files, over ``repro_torch``, plus ``--device`` (the
CUDA card unless the caller names another, e.g. ``--device cpu``).

Three modes:

``--mode sweep`` (default) runs every registered scenario (or a
``--scenarios`` subset) through the requested backends over the
scenario's default lambda path (or ``--lams``), and writes a JSON + CSV
report of reference metrics.  Dense/pallas sweeps reuse
:func:`repro_torch.api.solve_path` (one solve over a lane axis a lambda:
on the card the pallas rows run the fused kernel's lanes); the sharded
backend solves each
lambda separately through the continuation schedule.  With ``--tol``
every (backend, lambda) point instead runs a residual-stopped solve
(``SolverConfig.tol``) and the report records iterations-to-tolerance
per row.  Backends that cannot run a scenario (e.g. sharded x logistic
loss) are recorded as skips, not errors: the skip records catch
``NotImplementedError`` only, so a kernel that fails to build or launch
fails the run.

``--mode federated`` runs the federated message-passing runtime over a
grid of participation x compression configurations per scenario and
writes a *communication-vs-accuracy* report: final reference metrics,
the ledger totals, and a downsampled (cumulative bytes, objective) curve
per configuration — ``federated_report.json`` / ``federated_report.csv``.

``--mode serving`` drives one :class:`repro_torch.serving.SolveService`
session
per (scenario, intensity) through a synthetic update stream and reports
the warm-start payoff — warm-vs-cold iteration ratio, p50/p99 request
latency, SLA fraction, plan-cache stats — as the stream intensity sweeps
from almost-static to nearly-cold: ``serving_report.json`` /
``serving_report.csv``.

    python experiments/run_torch.py --smoke            # CI-sized sweep
    python experiments/run_torch.py --smoke --device cpu   # on the CPU
    python experiments/run_torch.py --scenarios grid2d,small_world \
        --backends dense,pallas --out results/experiments
    python experiments/run_torch.py --mode federated --smoke \
        --participation full,bernoulli:0.5 --compression none,int8
    python experiments/run_torch.py --mode serving --smoke \
        --intensities 0.05,0.2 --churn-every 3

``REPRO_SOLVER_MAX_ITERS`` caps every solve phase (the CI smoke knob).
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np                                             # noqa: E402

import torch                                                   # noqa: E402

from repro_torch.api import (Solver, SolverConfig,             # noqa: E402
                             get_backend, solve_path)
from repro_torch.core.mesh import make_host_mesh               # noqa: E402
from repro_torch.device import to_host                         # noqa: E402
from repro_torch.scenarios import SCENARIOS, get_scenario      # noqa: E402

METRIC_KEYS = ("objective", "weight_mse", "prediction_mse", "accuracy")
CSV_FIELDS = ("scenario", "backend", "lam", *METRIC_KEYS,
              "dual_infeasibility", "tol", "iterations", "sweep_seconds",
              "num_nodes", "num_edges", "status")


def _row(inst, backend, lam, metrics, diag, seconds, status="ok",
         tol=None, iterations=None):
    g = inst.problem.graph
    row = {"scenario": inst.name, "backend": backend, "lam": float(lam),
           "dual_infeasibility": diag, "tol": tol,
           "iterations": iterations, "sweep_seconds": seconds,
           "num_nodes": g.num_nodes, "num_edges": g.num_edges,
           "status": status}
    for k in METRIC_KEYS:
        row[k] = metrics.get(k)
    return row


def run_scenario(name: str, backends: list[str], *, seed: int, smoke: bool,
                 lams: list[float] | None, config: SolverConfig,
                 tol: float | None = None, tol_every: int = 50,
                 device=None):
    """All (backend, lambda) rows for one scenario (plus skip records),
    on ``device`` (``None`` = the CUDA card).

    With ``tol`` set, every (backend, lambda) point runs as its own
    residual-stopped solve (per-lambda early stopping needs per-lambda
    solves, as in the reference) and the row
    records the iterations-to-tolerance from the solver diagnostics.
    Deliberately *cold-start and single-phase on every backend* —
    including sharded, which the metric sweep runs through the
    continuation schedule — so iterations-to-tolerance means the same
    thing in every row (continuation would reduce ``iterations`` to the
    final phase of a two-phase schedule and make backends incomparable).
    """
    scenario = get_scenario(name)
    inst = scenario.build(seed=seed, smoke=smoke, device=device)
    path = tuple(lams) if lams else scenario.lam_path
    rows, skips = [], []
    for backend in backends:
        t0 = time.perf_counter()
        try:
            if tol is not None:
                # residual cadence can't exceed the budget; round the
                # budget down to a whole number of chunks (never to 0)
                every = max(1, min(tol_every, config.num_iters))
                cfg = config.replace(
                    backend=backend, tol=tol, metric_every=every,
                    num_iters=config.num_iters
                    - config.num_iters % every)
                if backend == "sharded":
                    cfg = cfg.replace(
                        mesh=make_host_mesh(1, 1, device=device))
                solver = Solver(cfg)
                results = [(lam, solver.run(inst.problem.with_lam(
                    float(lam)))) for lam in path]
                seconds = time.perf_counter() - t0
                for lam, res in results:
                    metrics = inst.evaluate(res.w, lam=float(lam))
                    diag = float(res.diagnostics["dual_infeasibility"])
                    rows.append(_row(
                        inst, backend, lam, metrics, diag, seconds,
                        tol=tol,
                        iterations=res.diagnostics.get("iterations")))
            elif backend in ("dense", "pallas"):
                res = solve_path(inst.problem, path,
                                 config.replace(backend=backend))
                seconds = time.perf_counter() - t0
                for i, lam in enumerate(path):
                    metrics = inst.evaluate(res.w[i], lam=float(lam))
                    diag = float(res.diagnostics["dual_infeasibility"][i])
                    rows.append(_row(inst, backend, lam, metrics, diag,
                                     seconds))
            else:
                solver = Solver(config.replace(
                    backend=backend, continuation=True,
                    mesh=make_host_mesh(1, 1, device=device)))
                results = [(lam, solver.run(inst.problem.with_lam(
                    float(lam)))) for lam in path]
                # like the lane sweep: one whole-path wall time per row
                seconds = time.perf_counter() - t0
                for lam, res in results:
                    metrics = inst.evaluate(res.w, lam=float(lam))
                    diag = float(res.diagnostics["dual_infeasibility"])
                    rows.append(_row(inst, backend, lam, metrics, diag,
                                     seconds))
        except NotImplementedError as e:
            skips.append({"scenario": name, "backend": backend,
                          "reason": str(e)})
    return rows, skips


# ---------------------------------------------------------------------------
# Serving mode: warm-start payoff over update-stream intensities
# ---------------------------------------------------------------------------

SERVING_CSV_FIELDS = ("scenario", "mode", "drift_fraction", "drift_scale",
                      "churn_every", "steps", "lam", "tol",
                      "cold_start_iterations", "warm_cold_iter_ratio",
                      "latency_p50_ms", "latency_p99_ms",
                      "sla_met_fraction", "max_residual",
                      "cache_hit_rate", "compiles",
                      "batch_sessions", "sequential_ms", "batched_ms",
                      "throughput_gain", "queue_flushes", "queue_batched",
                      "persistence_replans", "persistence_cache_hit",
                      "seconds", "status")


def run_serving_scenario(name: str, intensities, *, seed: int, smoke: bool,
                         steps: int, churn_every: int, device=None):
    """One SolveService session per (scenario, intensity) row.

    Each row replays a ``steps``-event drift stream at the given
    intensity (drift_fraction; noise scale rides it at 2x) and answers
    every event warm *and* cold, so the warm-vs-cold iteration ratio is
    measured against the identical problem state.  Intensity sweeps the
    serving regime from "almost-static session" to "every solve is
    nearly cold".
    """
    from repro_torch.serving import SolveService, latency_stats, replay, \
        synthetic_stream

    scenario = get_scenario(name)
    rows = []
    for intensity in intensities:
        inst = scenario.build(seed=seed, smoke=smoke, device=device)
        problem = inst.problem.with_lam(float(scenario.lam))
        svc = SolveService()
        sid = svc.create_session("sweep", problem)
        t0 = time.perf_counter()
        first = svc.solve(sid)
        rng = np.random.default_rng(seed + 1)
        events = synthetic_stream(
            rng, problem.data, problem.graph, num_steps=steps,
            drift_fraction=intensity, drift_scale=2.0 * intensity,
            churn_every=churn_every)
        records = replay(svc, sid, events, cold_reference=True)
        seconds = time.perf_counter() - t0
        warm = sum(r["warm_iterations"] for r in records)
        cold = sum(r["cold_iterations"] for r in records)
        stats = latency_stats(records)
        led = svc.ledger("sweep")
        rows.append({
            "scenario": name, "mode": "stream",
            "drift_fraction": float(intensity),
            "drift_scale": 2.0 * float(intensity),
            "churn_every": churn_every, "steps": steps,
            "lam": float(scenario.lam), "tol": svc.config.tol,
            "cold_start_iterations": first.iterations,
            "warm_cold_iter_ratio": warm / cold if cold else None,
            "latency_p50_ms": stats["p50"] * 1e3,
            "latency_p99_ms": stats["p99"] * 1e3,
            "sla_met_fraction": float(np.mean(
                [r["warm_meets_sla"] for r in records])),
            "max_residual": float(max(
                r["warm_residual"] for r in records)),
            "cache_hit_rate": led.cache_hit_rate,
            "compiles": led.compiles,
            "seconds": seconds, "status": "ok",
        })
    return rows


def run_serving_batched(name: str, *, seed: int, smoke: bool,
                        batch_sessions: int, out_dir: str,
                        device=None) -> dict:
    """One batched-serving row: sequential vs batched warm throughput.

    ``batch_sessions`` shape-matched sessions (same graph, re-seeded
    labels) are answered warm both sequentially and as one queue-driven
    ``solve_batch`` flush; the row also restarts the plan cache through
    ``save_plans``/``load_plans`` and reports how many re-plans the
    restarted service paid (expected: 0).
    """
    import dataclasses

    from repro_torch.serving import ServingQueue, SolveService, solve_batch

    scenario = get_scenario(name)
    inst = scenario.build(seed=seed, smoke=smoke, device=device)
    problem = inst.problem.with_lam(float(scenario.lam))

    y0 = to_host(problem.data.y)
    scale = 0.05 * (float(np.std(y0)) or 1.0)
    svc = SolveService()
    sids = []
    for i in range(batch_sessions):
        rng = np.random.default_rng(seed + 1000 + i)
        y = y0 + scale * rng.standard_normal(y0.shape).astype(np.float32)
        p = dataclasses.replace(
            problem, data=dataclasses.replace(
                problem.data, y=torch.as_tensor(y, device=problem.device)))
        sids.append(svc.create_session(f"batch_{i}", p))

    t0 = time.perf_counter()
    for sid in sids:                      # cold: plans
        svc.solve(sid)
    for sid in sids:                      # settle the warm state
        svc.solve(sid)
    solve_batch(svc, sids)                # the batched solve's first run
    seq_times, batch_times = [], []
    for _ in range(3):                    # interleaved best-of-3
        t1 = time.perf_counter()
        for sid in sids:
            svc.solve(sid)
        seq_times.append(time.perf_counter() - t1)
        t1 = time.perf_counter()
        solve_batch(svc, sids)
        batch_times.append(time.perf_counter() - t1)
    sequential_s, batched_s = min(seq_times), min(batch_times)

    queue = ServingQueue(svc, max_batch=batch_sessions,
                         max_wait_requests=4 * batch_sessions)
    tickets = [queue.submit(sid) for sid in sids]
    queue.drain()
    assert all(t is not None and t.done for t in tickets)

    plans_dir = os.path.join(out_dir, "serving_plans", name)
    svc.save_plans(plans_dir)
    restarted = SolveService()
    restarted.load_plans(plans_dir, device=problem.device)
    rsid = restarted.create_session("restart", problem)
    rresp = restarted.solve(rsid)

    return {
        "scenario": name, "mode": "batched",
        "lam": float(scenario.lam), "tol": svc.config.tol,
        "batch_sessions": batch_sessions,
        "sequential_ms": sequential_s * 1e3,
        "batched_ms": batched_s * 1e3,
        "throughput_gain": (sequential_s / batched_s if batched_s
                            else None),
        "queue_flushes": queue.flushes, "queue_batched": queue.batched,
        "persistence_replans": int(restarted.plans.misses),
        "persistence_cache_hit": bool(rresp.cache_hit),
        "seconds": time.perf_counter() - t0, "status": "ok",
    }


def run_serving_mode(args) -> int:
    names = (args.scenarios.split(",") if args.scenarios
             else ["sbm_regression", "chain_changepoint"])
    for name in names:
        get_scenario(name)
    intensities = [float(x) for x in args.intensities.split(",")]
    steps = args.stream_steps if args.stream_steps else \
        (4 if args.smoke else 12)

    all_rows = []
    for name in names:
        t0 = time.perf_counter()
        rows = run_serving_scenario(
            name, intensities, seed=args.seed, smoke=args.smoke,
            steps=steps, churn_every=args.churn_every, device=args.device)
        all_rows.extend(rows)
        print(f"[{name}] {len(rows)} serving intensities "
              f"({time.perf_counter() - t0:.1f}s)")
        if args.batch_sessions > 1:
            row = run_serving_batched(
                name, seed=args.seed, smoke=args.smoke,
                batch_sessions=args.batch_sessions, out_dir=args.out,
                device=args.device)
            all_rows.append(row)
            print(f"[{name}] batched x{args.batch_sessions}: "
                  f"gain={row['throughput_gain']:.2f} "
                  f"re-plans={row['persistence_replans']} "
                  f"({row['seconds']:.1f}s)")

    report = {
        "mode": "serving",
        "config": {"seed": args.seed, "smoke": args.smoke,
                   "scenarios": names, "intensities": intensities,
                   "steps": steps, "churn_every": args.churn_every,
                   "batch_sessions": args.batch_sessions,
                   "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                   "max_iters_env":
                       os.environ.get("REPRO_SOLVER_MAX_ITERS")},
        "rows": all_rows,
    }
    os.makedirs(args.out, exist_ok=True)
    json_path = os.path.join(args.out, "serving_report.json")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=2)
    csv_path = os.path.join(args.out, "serving_report.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=SERVING_CSV_FIELDS,
                                extrasaction="ignore")
        writer.writeheader()
        writer.writerows(all_rows)
    print(f"serving report: {json_path} ({len(all_rows)} rows over "
          f"{len(names)} scenarios x {len(intensities)} intensities); "
          f"csv: {csv_path}")
    return 0


# ---------------------------------------------------------------------------
# Federated mode: communication-vs-accuracy over runtime configurations
# ---------------------------------------------------------------------------

FED_CSV_FIELDS = ("scenario", "participation", "compression", "local_steps",
                  "rounds", "lam", *METRIC_KEYS, "dual_infeasibility",
                  "total_bytes", "up_bytes", "down_bytes", "bytes_per_round",
                  "seconds", "status")


def _parse_policy(token: str, kind: str):
    """CLI policy token: ``name`` or ``name:value`` (the policy's primary
    knob — bernoulli/dropout sampling rate p, straggler p_slow, topk
    fraction)."""
    from repro_torch.federated import get_compression, get_participation

    name, _, value = token.partition(":")
    kwargs = {}
    if value:
        knob = {"bernoulli": "p", "dropout": "rate", "straggler": "p_slow",
                "topk": "fraction"}.get(name)
        if knob is None:
            raise ValueError(
                f"policy {name!r} takes no ':value' parameter")
        kwargs[knob] = float(value)
    getter = (get_participation if kind == "participation"
              else get_compression)
    return token, getter(name, **kwargs)


def _downsample(xs, ys, max_points: int = 50):
    idx = np.unique(np.linspace(0, len(xs) - 1, max_points).astype(int))
    return [float(xs[i]) for i in idx], [float(ys[i]) for i in idx]


def run_federated_scenario(name: str, participations, compressions, *,
                           seed: int, smoke: bool, rounds: int,
                           local_steps: int, device=None):
    """(participation x compression) communication-vs-accuracy rows."""
    from repro_torch.federated import (FederatedConfig, get_local_update,
                                       run_federated)

    scenario = get_scenario(name)
    inst = scenario.build(seed=seed, smoke=smoke, device=device)
    local = ("single" if local_steps <= 1
             else get_local_update("prox", num_steps=local_steps))
    rows = []
    for part_name, part in participations:
        for comp_name, comp in compressions:
            cfg = FederatedConfig(
                num_rounds=rounds, rho=1.9, participation=part,
                compression=comp, local_update=local, seed=seed)
            t0 = time.perf_counter()
            res = run_federated(inst.problem, cfg)
            seconds = time.perf_counter() - t0
            metrics = inst.evaluate(res.w)
            summary = res.ledger.summary()
            cum_bytes, obj = _downsample(res.ledger.cumulative_bytes(),
                                         to_host(res.objective))
            row = {"scenario": name, "participation": part_name,
                   "compression": comp_name, "local_steps": local_steps,
                   "rounds": int(summary["rounds"]),
                   "lam": float(scenario.lam),
                   "dual_infeasibility":
                       float(res.diagnostics["dual_infeasibility"]),
                   "total_bytes": summary["total_bytes"],
                   "up_bytes": summary["up_bytes"],
                   "down_bytes": summary["down_bytes"],
                   "bytes_per_round": summary["bytes_per_round"],
                   "seconds": seconds, "status": "ok",
                   "curve": {"cumulative_bytes": cum_bytes,
                             "objective": obj}}
            for k in METRIC_KEYS:
                row[k] = metrics.get(k)
            rows.append(row)
    return rows


def run_federated_mode(args) -> int:
    names = (args.scenarios.split(",") if args.scenarios
             else sorted(SCENARIOS))
    for name in names:
        get_scenario(name)
    participations = [_parse_policy(t, "participation")
                      for t in args.participation.split(",")]
    compressions = [_parse_policy(t, "compression")
                    for t in args.compression.split(",")]
    rounds = args.rounds if args.rounds else (500 if args.smoke else 2000)

    all_rows = []
    for name in names:
        t0 = time.perf_counter()
        rows = run_federated_scenario(
            name, participations, compressions, seed=args.seed,
            smoke=args.smoke, rounds=rounds, local_steps=args.local_steps,
            device=args.device)
        all_rows.extend(rows)
        print(f"[{name}] {len(rows)} federated configs "
              f"({time.perf_counter() - t0:.1f}s)")

    report = {
        "mode": "federated",
        "config": {"seed": args.seed, "smoke": args.smoke,
                   "scenarios": names, "rounds": rounds,
                   "local_steps": args.local_steps,
                   "participation": [n for n, _ in participations],
                   "compression": [n for n, _ in compressions],
                   "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                   "max_iters_env":
                       os.environ.get("REPRO_SOLVER_MAX_ITERS")},
        "rows": all_rows,
    }
    os.makedirs(args.out, exist_ok=True)
    json_path = os.path.join(args.out, "federated_report.json")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=2)
    csv_path = os.path.join(args.out, "federated_report.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=FED_CSV_FIELDS,
                                extrasaction="ignore")
        writer.writeheader()
        writer.writerows(all_rows)
    print(f"federated report: {json_path} ({len(all_rows)} rows over "
          f"{len(names)} scenarios x {len(participations)} participation "
          f"x {len(compressions)} compression); csv: {csv_path}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("sweep", "federated", "serving"),
                    default="sweep")
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated subset (default: all registered)")
    ap.add_argument("--backends", default="dense,pallas,sharded")
    ap.add_argument("--lams", default=None,
                    help="comma-separated lambda override for every scenario")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tol", type=float, default=None,
                    help="sweep mode: residual-based early stopping "
                         "tolerance; rows then record iterations-to-"
                         "tolerance per (scenario, backend, lambda)")
    ap.add_argument("--tol-every", type=int, default=50, dest="tol_every",
                    help="residual check cadence (metric_every) for --tol")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized instances and short iteration budgets")
    ap.add_argument("--out", default=os.path.join("results", "experiments"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    # federated-mode knobs
    ap.add_argument("--participation", default="full,bernoulli:0.5",
                    help="federated mode: comma list of participation "
                         "policies (name or name:value)")
    ap.add_argument("--compression", default="none,int8",
                    help="federated mode: comma list of compression "
                         "policies (name or name:value)")
    ap.add_argument("--local-steps", type=int, default=1, dest="local_steps",
                    help="federated mode: local prox steps per round")
    ap.add_argument("--rounds", type=int, default=None,
                    help="federated mode: rounds per run "
                         "(default 2000, smoke 500)")
    # serving-mode knobs
    ap.add_argument("--intensities", default="0.02,0.05,0.1,0.25",
                    help="serving mode: comma list of update-stream "
                         "intensities (drift_fraction per step; noise "
                         "scale rides at 2x)")
    ap.add_argument("--stream-steps", type=int, default=None,
                    dest="stream_steps",
                    help="serving mode: events per stream "
                         "(default 12, smoke 4)")
    ap.add_argument("--churn-every", type=int, default=0,
                    dest="churn_every",
                    help="serving mode: edge-churn cadence (0 disables)")
    ap.add_argument("--batch-sessions", type=int, default=4,
                    dest="batch_sessions",
                    help="serving mode: shape-matched sessions for the "
                         "batched solve row; <=1 disables")
    args = ap.parse_args(argv)

    if args.mode == "federated":
        return run_federated_mode(args)
    if args.mode == "serving":
        return run_serving_mode(args)

    names = (args.scenarios.split(",") if args.scenarios
             else sorted(SCENARIOS))
    backends = args.backends.split(",")
    # fail fast on typos — a bad name must not kill a half-finished sweep
    for name in names:
        get_scenario(name)
    for backend in backends:
        get_backend(backend)
    lams = ([float(x) for x in args.lams.split(",")] if args.lams else None)
    config = SolverConfig(
        rho=1.9,
        warm_iters=300 if args.smoke else 3000,
        final_iters=200 if args.smoke else 1000,
        num_iters=500 if args.smoke else 2000)

    all_rows, all_skips = [], []
    for name in names:
        t0 = time.perf_counter()
        rows, skips = run_scenario(name, backends, seed=args.seed,
                                   smoke=args.smoke, lams=lams,
                                   config=config, tol=args.tol,
                                   tol_every=args.tol_every,
                                   device=args.device)
        all_rows.extend(rows)
        all_skips.extend(skips)
        done = sorted({r["backend"] for r in rows})
        print(f"[{name}] {len(rows)} rows on {done} "
              f"({time.perf_counter() - t0:.1f}s)"
              + (f", skipped {[s['backend'] for s in skips]}"
                 if skips else ""))

    report = {
        "config": {"seed": args.seed, "smoke": args.smoke,
                   "backends": backends, "scenarios": names,
                   "tol": args.tol, "tol_every": args.tol_every,
                   "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
                   "max_iters_env":
                       os.environ.get("REPRO_SOLVER_MAX_ITERS")},
        "scenarios": {n: {"description": SCENARIOS[n].description,
                          "graph_family": SCENARIOS[n].graph_family,
                          "data_model": SCENARIOS[n].data_model,
                          "loss": SCENARIOS[n].loss,
                          "regularizer": SCENARIOS[n].regularizer,
                          "lam_path": list(SCENARIOS[n].lam_path),
                          "metric": SCENARIOS[n].metric}
                      for n in names},
        "rows": all_rows,
        "skipped": all_skips,
    }
    os.makedirs(args.out, exist_ok=True)
    json_path = os.path.join(args.out, "report.json")
    with open(json_path, "w") as f:
        json.dump(report, f, indent=2)
    csv_path = os.path.join(args.out, "report.csv")
    with open(csv_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=CSV_FIELDS)
        writer.writeheader()
        writer.writerows(all_rows)
    covered = {(r["scenario"], r["backend"]) for r in all_rows}
    print(f"report: {json_path} ({len(all_rows)} rows, "
          f"{len({s for s, _ in covered})} scenarios x "
          f"{len({b for _, b in covered})} backends); csv: {csv_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

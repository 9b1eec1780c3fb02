"""Synthetic update streams + replay harness for the solve service.

The port's ``repro.serving.stream``: the stream is drawn from a numpy
``Generator`` exactly as the reference draws it, so both packages
replay the same events from one seed.

``synthetic_stream`` turns a scenario instance into a sequence of
:class:`StreamEvent` updates — per-step data drift on a random node
subset, plus optional edge churn (drop one existing edge, add one
non-edge) — the workload shape a deployed GTVMin service sees: small
deltas against a long-lived problem.

``replay`` drives a service session through the events, records
per-request latency / iterations / residual / cache outcomes, and
optionally answers every event with a from-zeros *cold* solve too, so
the warm-vs-cold iteration ratio is measured against the same problem
state rather than a stale baseline.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.device import to_host
from repro_torch.serving.service import (DataDelta, EdgePatch,
                                         SolveResponse, SolveService)


@dataclasses.dataclass(frozen=True)
class StreamEvent:
    """One update-stream step: an optional delta and/or edge patch."""

    step: int
    delta: DataDelta | None = None
    patch: EdgePatch | None = None


def synthetic_stream(rng: np.random.Generator, data, graph, *,
                     num_steps: int, drift_fraction: float = 0.05,
                     drift_scale: float = 0.1,
                     churn_every: int = 0) -> list[StreamEvent]:
    """Generate a drift + churn update stream against (data, graph).

    Each step perturbs the labels of ``drift_fraction`` of the nodes by
    Gaussian noise of scale ``drift_scale`` (relative to the label std);
    every ``churn_every``-th step (0 disables) additionally drops one
    random existing edge and adds one random absent edge — the
    structure-changing case that exercises dual transfer + re-planning.
    """
    V = int(data.num_nodes)
    y = to_host(data.y).copy()                  # writable drift accumulator
    y_scale = float(np.std(y)) or 1.0
    k = max(int(round(drift_fraction * V)), 1)
    # running edge set so successive churn events stay consistent (built
    # only when churn is on: a million-node graph's set costs seconds)
    edges = ({(int(i), int(j))
              for i, j in zip(to_host(graph.src), to_host(graph.dst))}
             if churn_every else set())
    events = []
    for step in range(num_steps):
        nodes = tuple(int(v) for v in
                      rng.choice(V, size=k, replace=False))
        noise = rng.normal(0.0, drift_scale * y_scale,
                           size=(k,) + y.shape[1:])
        rows = y[list(nodes)] + noise.astype(y.dtype)
        delta = DataDelta(nodes=nodes, y=rows)
        y[list(nodes)] = rows                 # drift accumulates
        patch = None
        if churn_every and (step + 1) % churn_every == 0 and edges:
            drop = sorted(edges)[int(rng.integers(len(edges)))]
            for _ in range(64):               # rejection-sample a non-edge
                i, j = sorted(rng.choice(V, size=2, replace=False))
                if (int(i), int(j)) not in edges:
                    add = (int(i), int(j))
                    break
            else:
                add = None
            edges.discard(drop)
            adds = ()
            if add is not None:
                edges.add(add)
                adds = ((add[0], add[1], 1.0),)
            patch = EdgePatch(add=adds, drop=(drop,))
        events.append(StreamEvent(step=step, delta=delta, patch=patch))
    return events


def replay(service: SolveService, session_id: str,
           events: list[StreamEvent], *,
           cold_reference: bool = False) -> list[dict]:
    """Drive the session through ``events``; one record per event.

    Each record holds the warm response's latency / iterations /
    residual / cache outcome; with ``cold_reference=True`` every event
    is also answered from zeros against the *same* problem state (the
    warm solve runs first, so the cold reference measures the identical
    instance), giving an honest per-event warm-vs-cold comparison.
    Cold-reference solves reset the session's cold baseline as a side
    effect, keeping the ledger's saved-iterations accounting current.
    """
    records = []
    for ev in events:
        service.update_session(session_id, delta=ev.delta, patch=ev.patch)
        warm = service.solve(session_id)
        rec = {"step": ev.step,
               "structural": ev.patch is not None,
               **_flatten(warm, "warm")}
        if cold_reference:
            rec.update(_flatten(service.solve(session_id, cold=True),
                                "cold"))
        records.append(rec)
    return records


def _flatten(resp: SolveResponse, prefix: str) -> dict:
    return {
        f"{prefix}_seconds": resp.seconds,
        f"{prefix}_solve_seconds": resp.solve_seconds,
        f"{prefix}_compile_seconds": resp.compile_seconds,
        f"{prefix}_iterations": resp.iterations,
        f"{prefix}_residual": resp.residual,
        f"{prefix}_objective": resp.objective,
        f"{prefix}_cache_hit": resp.cache_hit,
        f"{prefix}_compiled": resp.compiled,
        f"{prefix}_meets_sla": resp.meets_sla,
    }


def latency_stats(records: list[dict], key: str = "warm_seconds") -> dict:
    """p50/p99/mean over a replay column (seconds by default)."""
    xs = np.asarray([r[key] for r in records], np.float64)
    if xs.size == 0:
        return {"p50": 0.0, "p99": 0.0, "mean": 0.0}
    return {"p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)),
            "mean": float(xs.mean())}

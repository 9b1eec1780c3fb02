"""Streaming multi-tenant solve service (serving layer), on the card.

The port's ``repro.serving``, name for name.  Public surface::

    from repro_torch.serving import SolveService, DataDelta, EdgePatch

    svc = SolveService()
    sid = svc.create_session("tenant-a", problem)
    resp = svc.solve(sid)                     # cold: builds the plan
    svc.update_session(sid, delta=DataDelta(nodes=(3,), y=new_rows))
    resp = svc.solve(sid)                     # warm + plan-cache hit
    assert resp.residual <= resp.tol

See ``service.py`` for the request surface, ``cache.py`` for plan
reuse and cross-process persistence (``PlanCache.save/load``, in the
reference's format), ``batch.py`` for lane-stacked multi-session solves
(``solve_many``), ``queue.py`` for the
admission-controlled request loop, ``ledger.py`` for per-tenant
accounting, and ``stream.py`` for the synthetic update-stream
benchmark harness.
"""
from repro_torch.serving.batch import SolveRequest, group_requests, solve_batch
from repro_torch.serving.cache import (Plan, PlanCache, PlanKey,
                                 layout_structure_hash)
from repro_torch.serving.ledger import ServiceLedger
from repro_torch.serving.queue import ServingQueue, Ticket
from repro_torch.serving.service import (DEFAULT_CONFIG, DataDelta, EdgePatch,
                                   Session, SolveResponse, SolveService)
from repro_torch.serving.stream import (StreamEvent, latency_stats, replay,
                                  synthetic_stream)

__all__ = [
    "DEFAULT_CONFIG",
    "DataDelta",
    "EdgePatch",
    "Plan",
    "PlanCache",
    "PlanKey",
    "ServiceLedger",
    "ServingQueue",
    "Session",
    "SolveRequest",
    "SolveResponse",
    "SolveService",
    "StreamEvent",
    "Ticket",
    "group_requests",
    "latency_stats",
    "layout_structure_hash",
    "replay",
    "solve_batch",
    "synthetic_stream",
]

"""Structured JSONL event log for the serving layer.

One event per answered request, emitted by the serving layer's
``SolveService._response`` (ported with serving, ROADMAP.md §1 item 12):
who asked (tenant, session), what it cost (queue wait in submit ticks,
batch width, iterations, compile/execute seconds), what the cache did
(plan hit, compile flag), and whether the answer certified
(``residual``, ``meets_sla``).  Events are strict JSON — non-finite
floats are serialized as ``null`` — so any log shipper can consume the
stream.

Default off (gated on :func:`repro_torch.obs.telemetry.enabled`); a sink is
attached with :func:`attach`.  An in-process ring buffer keeps the most
recent events regardless of whether a file sink is attached, and
:func:`rolling_latency` answers "p50/p99 right now" from the request
histograms (:class:`~repro_torch.obs.telemetry.Histogram` buckets), not from
the ring — the percentiles cover the whole process lifetime at O(1)
memory.

:func:`validate_event` / :func:`validate_jsonl` pin the schema; the
port's tests hold them to the reference's on the same events.
"""
from __future__ import annotations

import json
import math
from collections import deque

from repro_torch.obs import telemetry

#: Event schema: field -> (types, nullable).  ``validate_event`` also
#: rejects non-finite numbers — NaN/inf must have been mapped to null
#: at emit time.
EVENT_SCHEMA = {
    "seq": (int, False),
    "event": (str, False),
    "tenant": (str, False),
    "session": (str, False),
    "queue_wait": (int, False),       # submit ticks (the queue's clock)
    "batch_width": (int, False),
    "warm": (bool, False),
    "cache_hit": (bool, False),
    "compiled": (bool, False),
    "iterations": (int, False),
    "residual": (float, True),
    "meets_sla": (bool, False),
    "seconds": (float, False),
    "solve_seconds": (float, False),
    "compile_seconds": (float, False),
    "lam": (float, False),
    "tol": (float, True),
}

EVENT_KINDS = ("solve", "path")


class EventLog:
    """Ring buffer + optional JSONL file sink for request events."""

    def __init__(self, keep: int = 1024):
        self._recent: deque = deque(maxlen=keep)
        self._fh = None
        self._path: str | None = None
        self._seq = 0

    @property
    def path(self) -> str | None:
        return self._path

    def attach(self, path: str) -> None:
        """Start appending events to ``path`` (JSON lines)."""
        self.close()
        self._fh = open(path, "a", buffering=1)
        self._path = path

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
            self._path = None

    def emit(self, event: dict) -> dict:
        event = dict(event)
        event["seq"] = self._seq
        self._seq += 1
        self._recent.append(event)
        if self._fh is not None:
            # allow_nan=False would raise; non-finite floats were
            # already nulled by the emitter
            self._fh.write(json.dumps(event, sort_keys=True) + "\n")
        return event

    def recent(self) -> list:
        return list(self._recent)

    def reset(self) -> None:
        self.close()
        self._recent.clear()
        self._seq = 0


LOG = EventLog()


def attach(path: str) -> None:
    """Attach the process-wide event log to a JSONL file."""
    LOG.attach(path)


def reset() -> None:
    LOG.reset()


def _finite_or_none(v) -> float | None:
    v = float(v)
    return v if math.isfinite(v) else None


def record_request(*, event: str, tenant: str, session: str,
                   queue_wait: int, batch_width: int, warm: bool,
                   cache_hit: bool, compiled: bool, iterations: int,
                   residual: float, meets_sla: bool, seconds: float,
                   solve_seconds: float, compile_seconds: float,
                   lam: float, tol: float | None) -> dict | None:
    """Emit one request event (no-op while observability is disabled)."""
    if not telemetry.enabled():
        return None
    return LOG.emit({
        "event": event,
        "tenant": tenant,
        "session": session,
        "queue_wait": int(queue_wait),
        "batch_width": int(batch_width),
        "warm": bool(warm),
        "cache_hit": bool(cache_hit),
        "compiled": bool(compiled),
        "iterations": int(iterations),
        "residual": _finite_or_none(residual),
        "meets_sla": bool(meets_sla),
        "seconds": float(seconds),
        "solve_seconds": float(solve_seconds),
        "compile_seconds": float(compile_seconds),
        "lam": float(lam),
        "tol": None if tol is None else float(tol),
    })


def rolling_latency() -> dict:
    """In-process p50/p99/count of request latency, from the request
    histograms (whole-process window, O(1) memory)."""
    total = telemetry.histogram("repro_serving_request_seconds")
    execute = telemetry.histogram("repro_serving_execute_seconds")
    return {
        "count": float(total.count),
        "p50": total.percentile(0.50),
        "p99": total.percentile(0.99),
        "execute_p50": execute.percentile(0.50),
        "execute_p99": execute.percentile(0.99),
    }


# ---------------------------------------------------------------------------
# Schema validation
# ---------------------------------------------------------------------------

def validate_event(event: dict) -> None:
    """Raise ValueError unless ``event`` matches :data:`EVENT_SCHEMA`."""
    if not isinstance(event, dict):
        raise ValueError(f"event must be an object, got {type(event)}")
    missing = sorted(set(EVENT_SCHEMA) - set(event))
    if missing:
        raise ValueError(f"event missing fields: {missing}")
    extra = sorted(set(event) - set(EVENT_SCHEMA))
    if extra:
        raise ValueError(f"event has unknown fields: {extra}")
    for field, (typ, nullable) in EVENT_SCHEMA.items():
        v = event[field]
        if v is None:
            if not nullable:
                raise ValueError(f"{field} must not be null")
            continue
        if typ is float:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError(f"{field} must be a number, got {v!r}")
            if not math.isfinite(v):
                raise ValueError(f"{field} is not finite: {v!r}")
        elif not isinstance(v, typ) or (typ is int and isinstance(v, bool)):
            raise ValueError(
                f"{field} must be {typ.__name__}, got {v!r}")
    if event["event"] not in EVENT_KINDS:
        raise ValueError(f"unknown event kind {event['event']!r}")
    for field in ("queue_wait", "batch_width", "iterations", "seconds",
                  "solve_seconds", "compile_seconds"):
        if event[field] is not None and event[field] < 0:
            raise ValueError(f"{field} must be >= 0, got {event[field]}")
    if event["batch_width"] < 1:
        raise ValueError("batch_width must be >= 1")


def validate_jsonl(path: str) -> int:
    """Validate every line of a JSONL event log; returns the count.

    Strict JSON: ``NaN``/``Infinity`` literals are rejected (emitters
    must null non-finite values), as are duplicate/descending ``seq``.
    """
    def _no_const(name):
        raise ValueError(f"non-finite JSON literal {name!r}")

    count = 0
    last_seq = -1
    with open(path) as f:
        for lineno, line in enumerate(f, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line, parse_constant=_no_const)
                validate_event(event)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}") from None
            if event["seq"] <= last_seq:
                raise ValueError(
                    f"{path}:{lineno}: seq {event['seq']} not increasing")
            last_seq = event["seq"]
            count += 1
    return count

"""Admission-controlled request queue in front of the batch runner.

The port's ``repro.serving.queue``, unchanged in behaviour.

The synchronous serving loop: callers :meth:`~ServingQueue.submit`
solve requests, the queue admits or rejects them (bounded pending
depth, per-tenant in-flight caps), and a count-based batch window
decides when to flush — either the window fills (``max_batch`` pending
requests) or the oldest pending request has waited through
``max_wait_requests`` submissions.  Flushes hand the whole window to
:func:`repro_torch.serving.batch.solve_batch`, which solves
exec-sig-matched groups as lanes and falls back to sequential solves for
singletons.

Everything is host-side and synchronous — the harness has no wall
clock, so the batch window is counted in *requests*, not seconds; an
async front-end would swap the trigger, not the mechanics.
"""
from __future__ import annotations

import dataclasses

from repro_torch import obs
from repro_torch.serving.batch import SolveRequest, solve_batch
from repro_torch.serving.service import SolveResponse, SolveService


@dataclasses.dataclass
class Ticket:
    """One admitted request; ``response`` is filled at flush time.

    ``submit_at`` pins the admission-clock reading (total submit
    attempts) at admission; the flush measures the ticket's queue wait
    as the number of submissions that arrived after it.
    """

    request_id: int
    session_id: str
    tenant: str
    cold: bool = False
    submit_at: int = 0
    response: SolveResponse | None = None

    @property
    def done(self) -> bool:
        return self.response is not None


class ServingQueue:
    """Bounded solve queue with batch-window flushing.

    Admission control:
      * ``max_pending``            — queue depth; submits beyond it are
        rejected (returns None, counted in ``rejected_full``).
      * ``max_inflight_per_tenant``— pending requests per tenant;
        protects the batch window from a single noisy tenant
        (``rejected_tenant``).

    Flush policy (count-based window):
      * ``max_batch``              — flush as soon as this many requests
        are pending (the lane-stacked solve's batch width cap).
      * ``max_wait_requests``      — flush once this many submit
        attempts (admitted or rejected, including its own) have
        occurred since the oldest pending request arrived, bounding
        queueing delay for unpopular shapes; ``1`` degenerates to
        fully sequential serving.
    """

    def __init__(self, service: SolveService, *, max_pending: int = 64,
                 max_batch: int = 8, max_wait_requests: int = 8,
                 max_inflight_per_tenant: int = 4):
        if max_batch < 1 or max_pending < 1 or max_wait_requests < 1:
            raise ValueError("queue limits must be >= 1")
        self.service = service
        self.max_pending = int(max_pending)
        self.max_batch = int(max_batch)
        self.max_wait_requests = int(max_wait_requests)
        self.max_inflight_per_tenant = int(max_inflight_per_tenant)
        self._pending: list[Ticket] = []
        self._submits = 0          # total submit attempts (admission clock)
        self._oldest_submit: int | None = None
        self._next_id = 0
        # stats
        self.submitted = 0
        self.rejected_full = 0
        self.rejected_tenant = 0
        self.flushes = 0
        self.batched = 0           # responses produced by multi-flushes
        self.singletons = 0        # responses produced by 1-wide flushes

    # -- admission -----------------------------------------------------------
    def pending(self) -> int:
        return len(self._pending)

    def inflight(self, tenant: str) -> int:
        return sum(1 for t in self._pending if t.tenant == tenant)

    def submit(self, session_id: str, *, cold: bool = False) -> Ticket | None:
        """Admit a solve request; returns its Ticket, or None if
        rejected (queue full / tenant over its in-flight cap).

        Admission may trigger a flush — the returned ticket can already
        be ``done``.
        """
        sess = self.service.session(session_id)   # unknown id raises
        self._submits += 1
        if len(self._pending) >= self.max_pending:
            self.rejected_full += 1
            self._count_submit("rejected_full")
            self._maybe_flush()
            return None
        if self.inflight(sess.tenant) >= self.max_inflight_per_tenant:
            self.rejected_tenant += 1
            self._count_submit("rejected_tenant")
            self._maybe_flush()
            return None
        ticket = Ticket(request_id=self._next_id, session_id=session_id,
                        tenant=sess.tenant, cold=cold,
                        submit_at=self._submits)
        self._next_id += 1
        self.submitted += 1
        if self._oldest_submit is None:
            self._oldest_submit = self._submits
        self._pending.append(ticket)
        self._count_submit("admitted")
        self._maybe_flush()
        return ticket

    def _maybe_flush(self) -> None:
        if not self._pending:
            return
        window_full = len(self._pending) >= self.max_batch
        waited = self._submits - self._oldest_submit
        if window_full or waited + 1 >= self.max_wait_requests:
            self.flush()

    # -- flushing ------------------------------------------------------------
    def flush(self) -> list[Ticket]:
        """Solve every pending request now (one batched dispatch)."""
        window, self._pending = self._pending, []
        self._oldest_submit = None
        if not window:
            return []
        self.flushes += 1
        if len(window) == 1:
            self.singletons += 1
        else:
            self.batched += len(window)
        reqs = [SolveRequest(t.session_id, cold=t.cold,
                             queue_wait=self._submits - t.submit_at)
                for t in window]
        for ticket, resp in zip(window, solve_batch(self.service, reqs)):
            ticket.response = resp
        return window

    def _count_submit(self, outcome: str) -> None:
        if not obs.enabled():
            return
        obs.counter("repro_queue_submits_total",
                    help="queue submissions by admission outcome",
                    outcome=outcome).inc()
        obs.gauge("repro_queue_pending",
                  help="requests waiting in the serving queue"
                  ).set(float(len(self._pending)))

    def drain(self) -> list[Ticket]:
        """Alias for :meth:`flush` — end-of-stream convenience."""
        return self.flush()

    def stats(self) -> dict[str, float]:
        """Flat float dict (JSON/CSV-ready) of queue totals."""
        return {
            "submitted": float(self.submitted),
            "rejected_full": float(self.rejected_full),
            "rejected_tenant": float(self.rejected_tenant),
            "flushes": float(self.flushes),
            "batched": float(self.batched),
            "singletons": float(self.singletons),
            "pending": float(len(self._pending)),
        }

"""Process-wide metrics registry: counters, gauges, histograms, spans.

The port's copy of ``repro.obs.telemetry``, with the same metric names:
the single place every layer meters into — the solver's transfer
counter, the solve counter and span, the federated CommLedger totals.
Everything is host-side and synchronous, and everything is **off by
default**: the registry only records when observability is enabled, via
the ``REPRO_OBS=1`` environment variable or :func:`enable`.

Zero-overhead contract: with observability disabled, every mutation
method returns after a single attribute check, :func:`span` returns a
shared no-op context manager (no ``perf_counter`` call, no allocation),
and :func:`device_fetch` does its one copy and its count and nothing
else.  Device-side phase ranges live in :mod:`repro_torch.obs.profile`
and are entered only while telemetry is on or a profiler runs.

Metric handles are process-wide singletons keyed by (name, labels):
``counter("x", tenant="a")`` returns the same object on every call, so
call sites never hold state.  Histograms use fixed buckets (Prometheus
style: cumulative counts at export), which keeps p50/p99 derivable at
any time without storing samples.
"""
from __future__ import annotations

import bisect
import os
import threading
import time

import torch

#: Latency buckets (seconds): ~log-spaced from 100us to 30s.
SECONDS_BUCKETS = (1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
                   5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

#: Small-count buckets: batch widths, queue waits (in submit ticks).
COUNT_BUCKETS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


def _env_enabled() -> bool:
    val = os.environ.get("REPRO_OBS", "").strip().lower()
    return val not in ("", "0", "false", "no", "off")


class _State:
    __slots__ = ("enabled",)

    def __init__(self):
        self.enabled = _env_enabled()


_STATE = _State()


def enabled() -> bool:
    """True when the registry records (``REPRO_OBS=1`` or enable())."""
    return _STATE.enabled


def enable() -> None:
    _STATE.enabled = True


def disable() -> None:
    _STATE.enabled = False


# ---------------------------------------------------------------------------
# Metric types
# ---------------------------------------------------------------------------

class Counter:
    """Monotonic counter; ``inc`` is a no-op while disabled."""

    kind = "counter"
    __slots__ = ("name", "labels", "help", "value")

    def __init__(self, name: str, labels: tuple, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if _STATE.enabled:
            self.value += n


class Gauge:
    """Last-write-wins value; ``set`` is a no-op while disabled."""

    kind = "gauge"
    __slots__ = ("name", "labels", "help", "value")

    def __init__(self, name: str, labels: tuple, help: str = ""):
        self.name = name
        self.labels = labels
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        if _STATE.enabled:
            self.value = float(v)


class Histogram:
    """Fixed-bucket histogram (upper bounds; +Inf bucket implicit).

    ``counts[i]`` holds observations <= ``bounds[i]`` (non-cumulative in
    memory; the Prometheus exporter accumulates).  ``percentile`` reads
    a quantile back out by linear interpolation inside the bucket the
    quantile lands in — exact enough for rolling p50/p99 without keeping
    samples.
    """

    kind = "histogram"
    __slots__ = ("name", "labels", "help", "bounds", "counts", "sum",
                 "count")

    def __init__(self, name: str, labels: tuple, help: str = "",
                 buckets: tuple = SECONDS_BUCKETS):
        self.name = name
        self.labels = labels
        self.help = help
        self.bounds = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        if not _STATE.enabled:
            return
        v = float(v)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.sum += v
        self.count += 1

    def percentile(self, q: float) -> float:
        """Quantile in [0, 1] from the bucket counts; 0.0 when empty.

        Observations in the +Inf bucket report the largest finite bound
        — a floor, not an estimate, but it keeps the value finite.
        """
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev_cum, cum = cum, cum + c
            if cum >= target:
                if i >= len(self.bounds):          # +Inf bucket
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i else 0.0
                hi = self.bounds[i]
                frac = (target - prev_cum) / c
                return lo + frac * (hi - lo)
        return self.bounds[-1]


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

class Registry:
    """Process-wide metric store keyed by (name, sorted labels)."""

    def __init__(self):
        self._metrics: dict = {}
        self._lock = threading.Lock()

    def get(self, cls, name: str, help: str, labels: dict, **kw):
        lab = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        key = (name, lab)
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, lab, help=help, **kw)
                    self._metrics[key] = m
        if type(m) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as {m.kind}, "
                f"requested {cls.kind}")
        return m

    def metrics(self) -> list:
        """All registered metrics, sorted by (name, labels)."""
        return [m for _, m in sorted(self._metrics.items())]

    def find(self, name: str) -> list:
        return [m for m in self.metrics() if m.name == name]

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


REGISTRY = Registry()


def counter(name: str, help: str = "", **labels) -> Counter:
    return REGISTRY.get(Counter, name, help, labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return REGISTRY.get(Gauge, name, help, labels)


def histogram(name: str, help: str = "",
              buckets: tuple = SECONDS_BUCKETS, **labels) -> Histogram:
    return REGISTRY.get(Histogram, name, help, labels, buckets=buckets)


def reset() -> None:
    """Clear every registered metric (test isolation; events reset
    separately via :func:`repro_torch.obs.events.reset`)."""
    REGISTRY.reset()


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class _NullSpan:
    """Shared do-nothing context manager returned while disabled."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_hist", "_t0")

    def __init__(self, hist: Histogram):
        self._hist = hist
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.perf_counter() - self._t0)
        return False


def span(name: str, **labels):
    """Context timer recording into ``repro_span_seconds{span=name}``.

    Host wall time.  On the card a span around a solve ends once the
    solve's work has been enqueued, as the reference's span ends at
    JAX's asynchronous dispatch: it adds no ``torch.cuda.synchronize``,
    which would be a second device->host wait in a tol solve and break
    its one-fetch contract under ``torch.cuda.set_sync_debug_mode``.

    Disabled mode returns the shared :data:`NULL_SPAN` singleton — no
    clock read, no allocation, no registry lookup.
    """
    if not _STATE.enabled:
        return NULL_SPAN
    return _Span(histogram("repro_span_seconds",
                           help="host-side span timings by phase",
                           span=name, **labels))


# ---------------------------------------------------------------------------
# The library-level device->host transfer counter
# ---------------------------------------------------------------------------

def device_fetch(t: torch.Tensor):
    """The solver stack's one deliberate device->host transfer: a tol
    solve's stopping iteration, as a Python int (a 0-d tensor), or a
    lane sweep's facts as one numpy array (its block count and per-lane
    stopping iterations, in one tensor).

    Every tol solve routes its single fetch through here.
    ``device_fetch.calls`` counts the calls always (the tests' transfer
    guard), and ``repro_transfers_device_to_host_total`` counts them
    while telemetry is enabled, as the reference's does, so "one
    transfer per tol solve" is a dashboard fact too.  It is the one call
    of a solve that may synchronize: under
    ``torch.cuda.set_sync_debug_mode`` it lifts the mode for its own copy
    and restores it.
    """
    device_fetch.calls += 1
    if _STATE.enabled:
        counter("repro_transfers_device_to_host_total",
                help="deliberate device->host fetches by the solver "
                     "stack").inc()
    if t.device.type != "cuda":
        host = t.numpy()
    else:
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            host = t.to("cpu").numpy()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return int(host) if t.ndim == 0 else host


device_fetch.calls = 0

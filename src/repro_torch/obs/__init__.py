"""repro_torch.obs: the port's telemetry, with the reference's names.

Public surface (as ``repro.obs``)::

    from repro_torch import obs

    obs.enable()                        # or REPRO_OBS=1 in the env
    obs.events.attach("events.jsonl")   # stream one event per request

    with obs.span("my_phase"):          # host-side timing
        ...
    obs.counter("my_total").inc()

    print(obs.export.prometheus_text())  # or obs.export.export_json()

Everything defaults **off** and costs nothing while off: see
``telemetry.py`` for the zero-overhead contract, ``events.py`` for the
request event log, ``export.py`` for JSON/Prometheus snapshots, and
``profile.py`` for the paper-phase ranges of a device trace.
"""
from repro_torch.obs import events, export, profile, telemetry
from repro_torch.obs.telemetry import (COUNT_BUCKETS, NULL_SPAN, REGISTRY,
                                       SECONDS_BUCKETS, Counter, Gauge,
                                       Histogram, counter, device_fetch,
                                       disable, enable, enabled, gauge,
                                       histogram, span)


def reset() -> None:
    """Clear all metrics and the event log (test isolation)."""
    telemetry.reset()
    events.reset()


__all__ = [
    "COUNT_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "NULL_SPAN",
    "REGISTRY",
    "SECONDS_BUCKETS",
    "counter",
    "device_fetch",
    "disable",
    "enable",
    "enabled",
    "events",
    "export",
    "gauge",
    "histogram",
    "profile",
    "reset",
    "span",
    "telemetry",
]

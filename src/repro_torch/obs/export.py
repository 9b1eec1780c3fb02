"""Registry snapshots: JSON and Prometheus text exposition.

``snapshot()`` is the canonical read: one dict covering every
registered metric (counters/gauges as values, histograms as cumulative
buckets + sum/count + derived p50/p99) plus the rolling request-latency
summary.  ``export_json`` serializes it with ``allow_nan=False`` — a
non-finite metric value is a bug in the emitter (the ledger exporters
guard their ratios), and the export fails loudly instead of shipping
``NaN`` to a dashboard.

``prometheus_text`` renders the standard text exposition format
(HELP/TYPE comments, cumulative ``_bucket{le=...}`` + ``_sum`` /
``_count`` for histograms); ``validate_prometheus`` parses it back,
rejecting malformed lines, non-finite samples, and TYPE declarations
with no samples.
"""
from __future__ import annotations

import json
import math
import re

from repro_torch.obs import events, telemetry

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*$")
_SAMPLE_RE = re.compile(
    r"(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")


def _label_dict(labels: tuple) -> dict:
    return {k: v for k, v in labels}


def snapshot() -> dict:
    """Every registered metric, JSON-ready (finite values only)."""
    metrics = []
    for m in telemetry.REGISTRY.metrics():
        entry = {"name": m.name, "kind": m.kind,
                 "labels": _label_dict(m.labels)}
        if m.kind == "histogram":
            cum = 0
            buckets = []
            for bound, c in zip(m.bounds, m.counts):
                cum += c
                buckets.append([bound, cum])
            entry.update(count=m.count, sum=m.sum,
                         p50=m.percentile(0.50), p99=m.percentile(0.99),
                         buckets=buckets)
        else:
            entry["value"] = m.value
        metrics.append(entry)
    return {
        "enabled": telemetry.enabled(),
        "metrics": metrics,
        "rolling_latency": events.rolling_latency(),
    }


def export_json(path: str | None = None) -> str:
    """Serialize :func:`snapshot`; raises on any non-finite value."""
    text = json.dumps(snapshot(), indent=1, sort_keys=True,
                      allow_nan=False)
    if path is not None:
        with open(path, "w") as f:
            f.write(text + "\n")
    return text


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _fmt_labels(labels: tuple, extra: tuple = ()) -> str:
    pairs = list(labels) + list(extra)
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape(str(v))}"' for k, v in pairs)
    return "{" + body + "}"


def _fmt_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    return repr(float(v))


def prometheus_text() -> str:
    """Render the registry in Prometheus text exposition format."""
    by_name: dict = {}
    for m in telemetry.REGISTRY.metrics():
        by_name.setdefault(m.name, []).append(m)
    lines = []
    for name in sorted(by_name):
        group = by_name[name]
        if group[0].help:
            lines.append(f"# HELP {name} {group[0].help}")
        lines.append(f"# TYPE {name} {group[0].kind}")
        for m in group:
            if m.kind == "histogram":
                cum = 0
                for bound, c in zip(m.bounds, m.counts):
                    cum += c
                    lab = _fmt_labels(m.labels,
                                      (("le", _fmt_value(bound)),))
                    lines.append(f"{name}_bucket{lab} {cum}")
                lab = _fmt_labels(m.labels, (("le", "+Inf"),))
                lines.append(f"{name}_bucket{lab} {m.count}")
                lines.append(
                    f"{name}_sum{_fmt_labels(m.labels)} "
                    f"{_fmt_value(m.sum)}")
                lines.append(
                    f"{name}_count{_fmt_labels(m.labels)} {m.count}")
            else:
                lines.append(f"{name}{_fmt_labels(m.labels)} "
                             f"{_fmt_value(m.value)}")
    return "\n".join(lines) + "\n"


def export_prometheus(path: str | None = None) -> str:
    text = prometheus_text()
    if path is not None:
        with open(path, "w") as f:
            f.write(text)
    return text


def validate_prometheus(text: str) -> dict:
    """Parse a Prometheus text exposition; raise ValueError on any
    malformed line, non-finite sample, or sample-less TYPE declaration.

    Returns ``{metric_name: [(labels_str, value), ...]}`` with histogram
    series folded onto their base name (``_bucket``/``_sum``/``_count``
    suffixes stripped) so callers can check "metric present" directly
    against :func:`snapshot` names.
    """
    declared: dict = {}
    samples: dict = {}
    for lineno, line in enumerate(text.splitlines(), start=1):
        line = line.rstrip()
        if not line:
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 4)
            if len(parts) != 4 or not _NAME_RE.match(parts[2]) \
                    or parts[3] not in ("counter", "gauge", "histogram"):
                raise ValueError(f"line {lineno}: malformed TYPE: {line}")
            declared[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {line}")
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(
                f"line {lineno}: bad value {m.group('value')!r}") from None
        if math.isnan(value) or (math.isinf(value)
                                 and 'le="' not in (m.group("labels") or "")):
            raise ValueError(
                f"line {lineno}: non-finite sample: {line}")
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            trimmed = name[:-len(suffix)] if name.endswith(suffix) else None
            if trimmed and declared.get(trimmed) == "histogram":
                base = trimmed
                break
        samples.setdefault(base, []).append(
            (m.group("labels") or "", value))
    missing = sorted(n for n in declared if n not in samples)
    if missing:
        raise ValueError(f"TYPE declared but no samples: {missing}")
    return samples

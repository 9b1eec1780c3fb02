"""What the per-layer metric files (``metrics/<name>.py``) share.

Each reader takes the run's :class:`~perfbench.bench.Measured` and
returns a number, or ``None`` where the run has nothing to read (another
traffic kind, no trace): the harness then leaves the metric out.
"""
from __future__ import annotations

from perfbench import work

#: the fused step's kernels by the name the device trace gives them
ONE_LANE_KERNEL = ("fused_pd_step_kernel",)
LANES_KERNEL = ("fused_pd_step_lanes_kernel",)


def step_mfu_pct(run, kind: str):
    """The whole step's share of the chip's peak: every iteration the
    window's calls ran, at the least time the H100 could take for it
    (``work.py``), over the window's wall time."""
    if run.kind != kind:
        return None
    return 100.0 * run.least_window_seconds() / run.window_s


def idle_pct(run, kind: str):
    """The share of the traced part of the window (``bench.TRACE_SECONDS``)
    that no device operation covers (the union of their intervals)."""
    if run.kind != kind or run.trace is None:
        return None
    return run.trace.idle_pct()


def roofline_pct(run, kind: str, patterns, *, lanes: bool):
    """A kernel's share of its roofline: the least time of one step of
    the lanes it advances (``work.py``) over its mean device time a
    step, from the trace's events of the kernels named ``patterns``.
    One-lane steps are the traced calls' ``iterations`` and the sweeps'
    warm phases; lane steps are the sweeps' ``lane_step_iterations``."""
    if run.kind != kind or run.trace is None:
        return None
    seconds, count = run.trace.op_seconds(patterns)
    recs = run.traced_records
    if lanes:
        steps = sum(r.get("lane_step_iterations", 0) for r in recs)
        width = max((r.get("lanes", 1) for r in recs), default=1)
    else:
        steps = sum(r.get("iterations", 0) + r.get("one_lane_iterations", 0)
                    for r in recs)
        width = 1
    if not count or not steps:
        return None
    bound = work.least_seconds(run.step_work(width))
    return 100.0 * bound / (seconds / steps)

"""Device-profile hooks: named phases + a torch.profiler wrapper.

The engine annotates the four primitives of Algorithm 1 (and the
residual / exchange machinery around them) under the reference's phase
names (``repro.obs.profile``), so a device trace groups kernels by
*paper* phase — "where did the milliseconds go" answers in terms of
eq. 14/15/11.

The reference's ``jax.named_scope`` works at trace time only and costs
nothing when the program runs.  Its counterpart here,
``torch.profiler.record_function``, is an eager range: it costs host time
on every call.  So :func:`annotate` enters one only while telemetry is
enabled (:func:`repro_torch.obs.telemetry.enabled`) or a profiler runs,
and otherwise returns the shared no-op context of
:data:`~repro_torch.obs.telemetry.NULL_SPAN`.  A range never
synchronizes the card and never changes numerics.

The fused kernel runs all five step phases in one launch, so it gets
one range per launch, :data:`FUSED_STEP` (``kernels/pd_step.py``).

:func:`trace` captures a ``torch.profiler`` trace of the block it wraps
(CPU, and CUDA when a card is present) and writes it as a Chrome trace
(``trace.json``) into ``logdir``; view it with Perfetto or
``chrome://tracing``.
"""
from __future__ import annotations

import contextlib
import os

import torch

from repro_torch.obs import telemetry

#: Paper-phase range names (engine/step.py): eqs. 14-15 split into the
#: four primitives plus the KM relaxation.
PHASE_GATHER = "alg1_gather_duals"        # D^T u
PHASE_PRIMAL = "alg1_primal_prox"         # eq. 17 / eq. 14
PHASE_EDGE_DIFF = "alg1_edge_diff"        # D (2 w+ - w)
PHASE_DUAL = "alg1_dual_prox"             # step 10 / eq. 15
PHASE_RELAX = "alg1_km_relaxation"
PHASE_RESIDUAL = "alg1_eq11_residual"     # stopping certificate
#: Exchange ranges (engine/executors.py).
PHASE_HALO_GATHER = "halo_exchange_gather"
PHASE_HALO_DIFF = "halo_exchange_diff"
PHASE_MAILBOX_DIFF = "mailbox_exchange_diff"
#: Loop ranges (engine/loop.py).
PHASE_METRIC_BLOCK = "solve_metric_block"
# a replay of a tol solve's captured metric block (engine/loop.py)
PHASE_METRIC_BLOCK_REPLAY = "solve_metric_block_replay"
PHASE_METRICS = "solve_metrics"
#: The fused kernel's one range a launch: the step phases it fuses.
FUSED_STEP = ("fused_pd_step[" + "+".join(
    (PHASE_GATHER, PHASE_PRIMAL, PHASE_EDGE_DIFF, PHASE_DUAL,
     PHASE_RELAX)) + "]")


def annotate(name: str):
    """A ``record_function`` range under a stable phase name while
    telemetry is enabled or a ``torch.profiler`` (or autograd profiler)
    records; else the shared no-op context (no allocation)."""
    if not (telemetry.enabled() or torch.autograd._profiler_enabled()):
        return telemetry.NULL_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str, **kwargs):
    """Capture a device profile of the enclosed block into ``logdir``.

    ``torch.profiler.profile`` over the CPU and, when a card is present,
    CUDA; on exit the trace is written to ``logdir/trace.json`` (Chrome
    trace format).  Extra kwargs pass through to the profiler.  The
    profiler is active inside the block, so :func:`annotate` records its
    ranges there even with telemetry off.
    """
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities, **kwargs) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

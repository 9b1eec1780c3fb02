"""The shared solve loop of the dense, fused and federated engines.

  * **metric cadence** — :func:`scan_solve` records traces every
    ``metric_every`` iterations, with the reference's three block shapes
    (``repro.engine.loop.scan_solve``) as a Python loop,
  * **device-resident early stopping** — :func:`device_loop` drives a
    ``SolverConfig.tol`` solve with its stopping test kept on the device
    and stops computing at the stop (the reference runs a
    ``lax.while_loop``; on the card a CUDA graph with a conditional
    node), :func:`device_loop_plain` is its plain version, and
    :func:`device_fetch` (``repro_torch.obs.telemetry``, re-exported
    here) is the one device->host transfer such a solve makes,
  * **host-side chunks** — :func:`run_chunked` drives a solve as a loop
    over chunks (the federated runtime's checkpoint schedule and its
    per-chunk tol test),
  * **iteration caps and warm starts** — the ``REPRO_SOLVER_MAX_ITERS``
    env cap and the continuation warm-lambda default used by
    ``Solver.run``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable

import torch

from repro_torch.obs import profile as _prof
from repro_torch.obs.profile import annotate as _scope
from repro_torch.obs.telemetry import device_fetch  # noqa: F401


def iter_cap() -> int:
    return int(os.environ.get("REPRO_SOLVER_MAX_ITERS", 1 << 30))


def capped(num_iters: int, metric_every: int = 1) -> int:
    """Apply the env cap, keeping the metric cadence divisibility.

    Leaves ``num_iters`` untouched when no cap bites.  When the cap
    bites, the result is the largest multiple of ``metric_every`` that
    does not exceed the cap; a cap that cannot fit even one metric block
    raises.
    """
    cap = iter_cap()
    if num_iters <= cap:
        return num_iters
    capped_iters = cap - (cap % metric_every if metric_every > 1 else 0)
    if capped_iters <= 0:
        raise ValueError(
            f"REPRO_SOLVER_MAX_ITERS={cap} cannot fit one metric block "
            f"(metric_every={metric_every}); lower metric_every or raise "
            "the cap")
    return capped_iters


def default_warm_lam(lam: float) -> float:
    """Continuation warm strength: 10x target, clipped to [1e-2, 1]."""
    return float(min(max(10.0 * lam, 1e-2), 1.0))


def scan_solve(run_block: Callable, metrics: Callable, state0, *,
               num_iters: int, metric_every: int,
               multi_iter_block: bool = False,
               residual_fn: Callable | None = None):
    """Run ``num_iters`` iterations, recording ``metrics`` on a cadence.

    ``run_block(state, iters)`` advances the solver state; ``metrics``
    maps a state to a tuple of scalar tensors.  Each metric block is

      * ``multi_iter_block=True`` — one ``run_block(state,
        metric_every)`` (the fused kernel's in-kernel iteration loop on
        a single-block layout),
      * otherwise                 — ``metric_every`` calls of
        ``run_block(state, 1)``.

    ``residual_fn(prev_state, new_state) -> scalar`` (optional) records
    the eq.-11 residual of each block's *closing* iteration, which then
    runs as its own ``run_block(state, 1)`` call so both endpoint states
    are in hand; ``run_block`` must leave the state it is given intact.
    The ys then become ``(metrics_ys, residual_ys)``.

    Returns ``(final_state, ys)`` with every ys leaf stacked to
    ``(num_iters // metric_every,)``, like ``jax.lax.scan``.
    """
    inner_metrics = metrics

    def metrics(state):
        with _scope(_prof.PHASE_METRICS):
            return inner_metrics(state)

    step = metric_every if multi_iter_block else 1
    lead = metric_every - (1 if residual_fn is not None else 0)
    state = state0
    records, residuals = [], []
    for _ in range(num_iters // metric_every):
        for _ in range(lead // step):
            state = run_block(state, step)
        if lead % step:
            state = run_block(state, lead % step)
        if residual_fn is not None:
            prev = state
            state = run_block(prev, 1)
            residuals.append(residual_fn(prev, state))
        records.append(metrics(state))
    ys = _stack(records, metrics, state)
    if residual_fn is None:
        return state, ys
    res = (torch.stack(residuals) if residuals
           else ys[0].new_zeros(ys[0].shape))
    return state, (ys, res)


def _stack(records: list, metrics: Callable, state) -> tuple:
    """Stack per-block metric tuples into per-metric (T, ...) tensors (a
    metric may be one value per lane); a 0-block run gives (0, ...)
    traces of the right device."""
    if records:
        return tuple(torch.stack(col) for col in zip(*records))
    shape = metrics(state)
    return tuple(torch.zeros((0,) + tuple(m.shape), dtype=m.dtype,
                             device=m.device) for m in shape)


def device_loop(run_block: Callable, state0, *, num_iters: int,
                metric_every: int, tol: float):
    """Drive a tol solve with the stopping test on the device.

    The reference runs its metric blocks in a ``lax.while_loop``.
    ``run_block(state, active) -> (state, records, residual)`` advances
    ``metric_every`` iterations and returns the block's records (a tuple
    of scalar tensors, or one value per lane) and its stopping residual
    (the max eq.-11 residual over the block); where the device flag
    ``active`` is clear it must leave the state exactly as it is (the
    fused kernel reads the flag and writes nothing; the dense blocks
    select their old state with ``torch.where``).  The flag is cleared
    on the device after the first block whose residual is <= tol, so,
    as in the reference, block 0 always runs and the solve stops after
    the first block at or below tol, or at the end of the budget.  The
    blocks run are counted on the device.

    The blocks after the stop are not computed:

      * on the CPU the flag lives in host memory, so the loop reads it
        (through a numpy view of the same bytes: no transfer, and no
        read of a tensor) and ends at the stop;
      * on the card block 0 runs as it is, and the block is then
        captured once into a CUDA graph under an IF node on the flag
        (:func:`_capture_block`, ``kernels/graph_if.py``), working in
        place on the block's state and writing its records through the
        device block count; the graph is replayed for the rest of the
        budget, and a replay after the stop runs nothing on the device
        but the node's flag test.  The block's profiler ranges
        (``alg1_*``, ``solve_metric_block``) are recorded at the
        capture; each replay is a ``solve_metric_block_replay`` range,
        under which a trace shows the kernels it ran.

    The kernels' launch counters count the launches of block 0 only: a
    kernel call inside a capture is recorded, not launched, and the
    replays launch the graph, not the kernel (each kernel counts its own
    runs on the card, ``kernels._build.executions``).

    Trace buffers are preallocated at the full budget (``num_iters //
    metric_every`` records).  Nothing here reads a device value on the
    host: the caller's single :func:`device_fetch` of the returned
    iteration count is the solve's one transfer, after which it
    truncates the traces.  Returns
    ``(state, traces, iterations)`` with ``iterations`` a device int32
    scalar.  :func:`device_loop_plain` is the plain version: every
    block enqueued, the blocks after the stop computed and dropped.
    """
    if state0[0].device.type == "cuda":
        return _graph_loop(run_block, state0, num_iters=num_iters,
                           metric_every=metric_every, tol=tol)
    return _host_loop(run_block, state0, num_iters=num_iters,
                      metric_every=metric_every, tol=tol, stop=True)


def device_loop_plain(run_block: Callable, state0, *, num_iters: int,
                      metric_every: int, tol: float):
    """The plain version of :func:`device_loop` on any device: every
    block of the budget enqueued behind the flag, so the blocks after
    the stop are computed and dropped.  The graph engine must give its
    state, traces and stopping iteration bit for bit."""
    return _host_loop(run_block, state0, num_iters=num_iters,
                      metric_every=metric_every, tol=tol, stop=False)


def _host_loop(run_block: Callable, state0, *, num_iters: int,
               metric_every: int, tol: float, stop: bool):
    """The block loop on the host: block ``k`` at the Python-int index,
    ending at the stop when ``stop`` is set (a CPU flag only)."""
    num_blocks = num_iters // metric_every
    dev = state0[0].device
    active = torch.ones((), dtype=torch.bool, device=dev)
    blocks = torch.zeros((), dtype=torch.int32, device=dev)
    # the flag's own bytes, seen from the host (CPU tensors only)
    flag = active.numpy() if stop else None
    state, traces = state0, None
    for k in range(num_blocks):
        if flag is not None and not flag[()]:
            break
        blocks.add_(active)
        with _scope(_prof.PHASE_METRIC_BLOCK):
            state, records, res = run_block(state, active)
        if traces is None:
            traces = _trace_buffers(records, num_blocks)
        for buf, r in zip(traces, records):
            buf[k] = r
        active.logical_and_(res > tol)
    return state, traces, blocks * metric_every


def _trace_buffers(records: tuple, num_blocks: int) -> tuple:
    return tuple(r.new_zeros((num_blocks,) + tuple(r.shape))
                 for r in records)


#: per device: the side stream every tol engine captures its block on,
#: the memory pool the captures share (a solve's graph is never replayed
#: after the next capture, so one pool serves them in turn), and the last
#: IF graph, which holds its capture, and so the pool, until the next
#: capture replaces it (its replays are then ordered before the capture)
_CAPTURE_STREAMS: dict = {}


def _graph_loop(run_block: Callable, state0, *, num_iters: int,
                metric_every: int, tol: float):
    """:func:`device_loop` on the card (see there)."""
    num_blocks = num_iters // metric_every
    dev = state0[0].device
    active = torch.ones((), dtype=torch.bool, device=dev)
    blocks = torch.ones((), dtype=torch.int32, device=dev)
    # block 0 always runs: as it is, so every kernel and library handle
    # the capture records is loaded first
    with _scope(_prof.PHASE_METRIC_BLOCK):
        state, records, res = run_block(state0, active)
    # the graph writes its state in place: never a tensor of the caller
    state = tuple(s.clone() if any(s is t for t in state0) else s
                  for s in state)
    traces = _trace_buffers(records, num_blocks)
    for buf, r in zip(traces, records):
        buf[0] = r
    active.logical_and_(res > tol)
    if num_blocks > 1:
        graph = _capture_block(run_block, state, traces, active, blocks,
                               tol)
        for _ in range(num_blocks - 1):
            with _scope(_prof.PHASE_METRIC_BLOCK_REPLAY):
                graph.replay()
    return state, traces, blocks * metric_every


def _capture_block(run_block: Callable, state: tuple, traces: tuple,
                   active, blocks, tol: float):
    """Capture one metric block and put it under an IF node on
    ``active`` (``kernels.graph_if.IfGraph``): the block on ``state``,
    its new state copied back into ``state``, its records written at
    index ``blocks`` of ``traces``, ``blocks`` counted and the flag
    updated.  Nothing synchronizes: the capture runs on a side stream
    that waits for the current one."""
    from repro_torch.kernels.graph_if import IfGraph

    dev = state[0].device
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = [torch.cuda.Stream(dev),
                                 torch.cuda.graph_pool_handle(), None]
    side, pool, _ = _CAPTURE_STREAMS[dev]
    current = torch.cuda.current_stream(dev)
    side.wait_stream(current)
    body = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.stream(side):
        body.capture_begin(pool=pool)
        try:
            with _scope(_prof.PHASE_METRIC_BLOCK):
                new, records, res = run_block(state, active)
            for s, n in zip(state, new):
                s.copy_(n)
            at = blocks.to(torch.int64).reshape(1)
            for buf, r in zip(traces, records):
                buf.index_copy_(0, at, r.unsqueeze(0))
            blocks.add_(1)
            active.logical_and_(res > tol)
        finally:
            body.capture_end()
    current.wait_stream(side)
    graph = IfGraph(body, active)
    if _CAPTURE_STREAMS[dev][2] is not None:
        _CAPTURE_STREAMS[dev][2].close()
    _CAPTURE_STREAMS[dev][2] = graph
    return graph


# ---------------------------------------------------------------------------
# The host-side chunk driver (checkpoint schedules + federated stopping)
# ---------------------------------------------------------------------------

def chunk_bounds(start: int, total: int, size: int) -> list[tuple[int, int]]:
    """[(r0, r1), ...] covering [start, total) in chunks of ``size``."""
    return [(r, min(r + size, total)) for r in range(start, total, size)]


def concat_traces(parts: list):
    """Concatenate per-chunk traces along their leading axis: tensors,
    tuples of them and dataclasses of them (a ``CommLedger``), nested as
    the reference's pytrees are."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(parts)
    if dataclasses.is_dataclass(first):
        return type(first)(*(concat_traces([getattr(p, f.name)
                                            for p in parts])
                             for f in dataclasses.fields(first)))
    return tuple(concat_traces(list(col)) for col in zip(*parts))


def run_chunked(run_chunk: Callable, state, *, total: int, start: int = 0,
                chunk_size: int, tol: float | None = None,
                on_chunk: Callable | None = None):
    """Drive a solve as a host-side loop over identical chunks.

    ``run_chunk(state, r0, r1) -> (state, traces, residual)`` advances
    ``r1 - r0`` iterations and returns its traces (leading axis = records
    in the chunk) plus the chunk's max per-iteration fixed-point residual
    (or None when not tracked).  ``on_chunk(state, r1, parts)`` fires
    after every chunk (checkpoint hook).  When ``tol`` is set, the loop
    stops at the first chunk whose residual is <= tol — every backend
    stops on the identical residual stream, so dense and federated_sync
    stop at the same iteration.

    Transfer contract, as the reference's: the per-chunk
    ``float(residual)`` device sync is the price of host-side stopping
    and is paid *only* when ``tol`` is set.  It is not a
    :func:`device_fetch` (the reference does not count it either), so
    the transfer counters read the same in both packages.

    Returns ``(state, traces, iterations_run, stopped_early)``.
    """
    parts = []
    iterations = start
    stopped = False
    for r0, r1 in chunk_bounds(start, total, chunk_size):
        state, traces, residual = run_chunk(state, r0, r1)
        parts.append(traces)
        iterations = r1
        if on_chunk is not None:
            on_chunk(state, r1, parts)
        if tol is None:
            continue                    # residual stays on device
        if residual is not None and float(residual) <= tol:
            stopped = True
            break
    traces = concat_traces(parts) if parts else None
    return state, traces, iterations, stopped

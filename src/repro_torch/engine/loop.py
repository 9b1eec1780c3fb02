"""The shared solve loop of the dense, fused and federated engines.

  * **metric cadence** — :func:`scan_solve` records traces every
    ``metric_every`` iterations, with the reference's three block shapes
    (``repro.engine.loop.scan_solve``) as a Python loop,
  * **device-resident early stopping** — :func:`device_loop` drives a
    ``SolverConfig.tol`` solve with its stopping test kept on the device
    (the reference runs a ``lax.while_loop``), and
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

    The reference runs its metric blocks in a ``lax.while_loop``; PyTorch
    has no device-side loop the port can rely on, so this enqueues every
    block of the budget and keeps a device flag ``active`` instead.
    ``run_block(state, active) -> (state, records, residual)`` advances
    ``metric_every`` iterations where ``active`` is set and leaves the
    state exactly as it is where it is clear (the fused kernel reads the
    flag and writes nothing; the dense block freezes its state with
    ``torch.where``), and returns the block's records (a tuple of scalar
    tensors) and its stopping residual (the max eq.-11 residual over the
    block).  The flag is cleared on the device after the first block
    whose residual is <= tol, so, as in the reference, block 0 always
    runs and the solve stops after the first block at or below tol, or
    at the end of the budget.

    Trace buffers are preallocated at the full budget (``num_iters //
    metric_every`` records) and written at the Python-int block index;
    the blocks run are counted on the device.  Nothing here reads a
    device value on the host: the caller's single :func:`device_fetch`
    of the returned iteration count is the solve's one transfer, after
    which it truncates the traces.  Returns ``(state, traces,
    iterations)`` with ``iterations`` a device int32 scalar.
    """
    num_blocks = num_iters // metric_every
    dev = state0[0].device
    active = torch.ones((), dtype=torch.bool, device=dev)
    blocks = torch.zeros((), dtype=torch.int32, device=dev)
    state, traces = state0, None
    for k in range(num_blocks):
        blocks.add_(active)
        with _scope(_prof.PHASE_METRIC_BLOCK):
            state, records, res = run_block(state, active)
        if traces is None:
            traces = tuple(r.new_zeros((num_blocks,) + tuple(r.shape))
                           for r in records)
        for buf, r in zip(traces, records):
            buf[k] = r
        active.logical_and_(res > tol)
    return state, traces, blocks * metric_every


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

"""The shared solve loop of the dense and fused engines.

  * **metric cadence** — :func:`scan_solve` records traces every
    ``metric_every`` iterations, with the reference's three block shapes
    (``repro.engine.loop.scan_solve``) as a Python loop,
  * **device-resident early stopping** — :func:`device_loop` drives a
    ``SolverConfig.tol`` solve with its stopping test kept on the device
    (the reference runs a ``lax.while_loop``), and
    :func:`device_fetch` is the one device->host transfer such a solve
    makes,
  * **iteration caps and warm starts** — the ``REPRO_SOLVER_MAX_ITERS``
    env cap and the continuation warm-lambda default used by
    ``Solver.run``.
"""
from __future__ import annotations

import os
from typing import Callable

import torch


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
        state, records, res = run_block(state, active)
        if traces is None:
            traces = tuple(r.new_zeros((num_blocks,) + tuple(r.shape))
                           for r in records)
        for buf, r in zip(traces, records):
            buf[k] = r
        active.logical_and_(res > tol)
    return state, traces, blocks * metric_every


def device_fetch(t: torch.Tensor):
    """The solver stack's one deliberate device->host transfer: a tol
    solve's stopping iteration, as a Python int (a 0-d tensor), or a
    lane sweep's facts as one numpy array (its block count and per-lane
    stopping iterations, in one tensor).

    Every tol solve routes its single fetch through here, and
    ``device_fetch.calls`` counts them.  It is the one call of a solve
    that may synchronize: under ``torch.cuda.set_sync_debug_mode`` it
    lifts the mode for its own copy and restores it.
    """
    device_fetch.calls += 1
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

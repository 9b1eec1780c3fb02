"""The shared solve loop of the dense and fused engines.

  * **metric cadence** — :func:`scan_solve` records traces every
    ``metric_every`` iterations, with the reference's three block shapes
    (``repro.engine.loop.scan_solve``) as a Python loop,
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
           else torch.zeros(0, device=ys[0].device))
    return state, (ys, res)


def _stack(records: list, metrics: Callable, state) -> tuple:
    """Stack per-block metric tuples into per-metric (T,) tensors; a
    0-block run gives (0,)-shaped traces of the right device."""
    if records:
        return tuple(torch.stack(col) for col in zip(*records))
    shape = metrics(state)
    return tuple(torch.zeros(0, dtype=m.dtype, device=m.device)
                 for m in shape)

"""The port's engine layer: one primal-dual step, its executors, one loop.

  * :mod:`repro_torch.engine.step` — the canonical :func:`pd_step` over a
    :class:`GraphExecutor`, the eq.-11 :func:`certificate`, and the
    fixed-point :func:`pd_residual`,
  * :mod:`repro_torch.engine.executors` — the dense gather-sum (one
    problem or lane-stacked), the edge-blocked window and the federated
    mailbox executors,
  * :mod:`repro_torch.engine.loop` — metric cadence, the device-resident
    tol loop (a CUDA graph on the card) and its one fetch, the host-side
    chunk driver, iteration caps and continuation defaults.
"""
from repro_torch.engine.executors import (BatchedDenseExecutor,
                                          DenseExecutor, MailboxExecutor,
                                          WindowExecutor)
from repro_torch.engine.loop import (capped, chunk_bounds, concat_traces,
                                     default_warm_lam, device_fetch,
                                     device_loop, device_loop_plain,
                                     iter_cap, run_chunked, scan_solve)
from repro_torch.engine.step import (GraphExecutor, certificate,
                                     ensure_column, optimality_gap,
                                     pd_residual, pd_step)

__all__ = [
    "BatchedDenseExecutor", "DenseExecutor", "GraphExecutor",
    "MailboxExecutor", "WindowExecutor", "capped", "certificate",
    "chunk_bounds", "concat_traces", "default_warm_lam", "device_fetch",
    "device_loop", "device_loop_plain", "ensure_column", "iter_cap",
    "optimality_gap", "pd_residual", "pd_step", "run_chunked",
    "scan_solve",
]

"""Declarative problem / config / result containers for the port's solver.

A :class:`Problem` is everything eq. (4) needs — the empirical graph, the
batched node-local datasets, the TV strength lambda, and the two
template slots (a :class:`~repro_torch.api.losses.Loss` and a
:class:`~repro_torch.api.regularizers.Regularizer`) — with its tensors
on one device.  :class:`SolverConfig` carries the *how*, and
:class:`SolveResult` is what every backend returns.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.api.losses import Loss, SquaredLoss, get_loss
from repro_torch.api.regularizers import (Regularizer, TotalVariation,
                                          get_regularizer)
from repro_torch.core.graph import EmpiricalGraph
from repro_torch.core.losses import NodeData
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Problem:
    """One networked-learning instance: min_w E_hat(w) + lam * g(D w)."""

    graph: EmpiricalGraph
    data: NodeData
    lam: float = 1e-3
    loss: Loss = SquaredLoss()
    regularizer: Regularizer = TotalVariation()

    @classmethod
    def create(cls, graph: EmpiricalGraph, data: NodeData, lam=1e-3, *,
               loss="squared", regularizer="tv", device=None,
               **loss_kwargs) -> "Problem":
        """Build a Problem on ``device`` (``None`` = CUDA), resolving
        registry names for the template slots."""
        dev = resolve_device(device)
        return cls(graph=graph.to(dev), data=data.to(dev), lam=float(lam),
                   loss=get_loss(loss, **loss_kwargs),
                   regularizer=get_regularizer(regularizer))

    def with_lam(self, lam) -> "Problem":
        """Same instance at a different TV strength (lambda-path helper)."""
        return dataclasses.replace(self, lam=float(lam))

    def objective(self, w: torch.Tensor) -> torch.Tensor:
        """Primal objective E_hat(w) + lam * g(D w) (paper eq. 4)."""
        return (self.loss.empirical_error(self.data, w)
                + self.regularizer.value(self.graph, w, self.lam))

    @property
    def device(self) -> torch.device:
        return self.graph.device

    @property
    def num_nodes(self) -> int:
        return self.data.num_nodes

    @property
    def num_features(self) -> int:
        return self.data.num_features


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """How to run Algorithm 1 (the reference's fields that this slice
    runs; see ``repro.api.problem.SolverConfig`` for the full set).

    Core iteration:
      num_iters:    primal-dual iterations (ignored when continuation=True).
      rho:          Krasnosel'skii-Mann over-relaxation in (0, 2).
      metric_every: objective/MSE cadence; must divide the iteration count.
      tol:          residual-based early stopping: the solve stops after
                    the first metric block whose eq.-11 residual (the
                    block max) is <= tol, with the test kept on the
                    device; the stopping iteration (the solve's one
                    device->host fetch) is ``diagnostics["iterations"]``
                    and the block residuals are ``SolveResult.residual``.
                    None runs the whole budget.  With continuation both
                    phases stop on it.
      record_residual: record the eq.-11 fixed-point residual in
                    ``SolveResult.residual`` at the metric cadence.

    Continuation: solve first at warm_lam (default 10x target clipped to
    [1e-2, 1]), re-project the duals, then solve at the target lambda
    (``continuation`` / ``warm_lam`` / ``warm_iters`` / ``final_iters``).

    Backend dispatch:
      backend:     "dense" (Python loop over the dense executor),
                   "pallas" (the port's kernels; the name is the
                   reference's) or "federated" (the round-based
                   message-passing runtime, ``repro_torch.federated``).
      fused:       pallas only — run the fused primal-dual kernel over
                   the edge-blocked layout instead of the dense engine
                   with the ``tv_prox`` / ``batched_affine`` kernels
                   wired in (the unfused path).  None resolves to True
                   when the problem lives on CUDA (the card takes the
                   TPU's role), False elsewhere; ``REPRO_FUSED`` (env)
                   overrides the default either way.  Every registered
                   loss fuses; a loss without ``prox_setup`` or a set
                   kernel hook falls back to the unfused path.
      clip_fn / affine_fn: custom kernel hooks for the dual clip and the
                   affine primal update (dense/pallas backends; the
                   pallas backend fills unset hooks with the port's
                   kernels, and a set hook disables fusion).
      federated:   federated-backend runtime knobs: a
                   ``repro_torch.federated.FederatedConfig`` whose
                   participation / local-update / compression /
                   checkpoint policies are used as-is while this config's
                   num_iters, rho, metric_every, tol and
                   compute_diagnostics override the loop shape.  None
                   runs the synchronous full-participation defaults (the
                   dense oracle mode).

    Precision: ``dtype`` "float32" (default) or "bfloat16".  bf16 is a
    storage policy of the fused path: the state and the float prox
    parameters are stored bf16 while every sum, prox solve, resolvent
    and residual runs in f32 (``kernels.ref.pd_window_step``); results
    come back f32.  The dense and unfused paths refuse it
    (``NotImplementedError``).
    """

    num_iters: int = 500
    rho: float = 1.0
    metric_every: int = 1
    tol: float | None = None
    record_residual: bool = False
    # continuation schedule
    continuation: bool = False
    warm_lam: float | None = None
    warm_iters: int = 3000
    final_iters: int = 1000
    # backend dispatch
    backend: str = "dense"
    fused: bool | None = None
    federated: Any = None
    # custom kernel hooks
    clip_fn: Any = dataclasses.field(default=None, compare=False,
                                     repr=False)
    affine_fn: Any = dataclasses.field(default=None, compare=False,
                                       repr=False)
    # eq.-11 certificate on the result (disabled internally for
    # warm-phase solves whose result is discarded)
    compute_diagnostics: bool = True
    dtype: str = "float32"

    def replace(self, **kw) -> "SolverConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class SolveResult:
    """What every backend returns.

    Attributes:
      w:           (V, n) final primal weights (original node order).
      u:           (E, n) final dual edge variables (original edge order).
      objective:   (T,) primal-objective trace (T = iters / metric_every).
      mse:         (T,) eq.-24 MSE trace vs. w_true, or None.
      lam:         the TV strength solved at.
      diagnostics: optimality certificate (eq. 11): ``dual_infeasibility``
                   always; ``stationarity_residual_labeled`` and, with
                   TV, ``optimality_gap`` for the squared loss.
      residual:    (T,) eq.-11 fixed-point residual trace, or None.
    """

    w: torch.Tensor
    u: torch.Tensor
    objective: torch.Tensor
    mse: torch.Tensor | None
    lam: float
    diagnostics: dict
    residual: torch.Tensor | None = None

    @property
    def final_objective(self) -> torch.Tensor:
        return self.objective[-1]

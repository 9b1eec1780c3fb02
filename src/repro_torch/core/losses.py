"""Batched node-local datasets + legacy loss adapters.

The loss numerics (paper §4.1-4.3: per-node loss values and the
primal-update operators of eq. 18) live in :mod:`repro_torch.api.losses`.
This module keeps:

  * :class:`NodeData` — the padded batched container for the local
    datasets X^(i) (the data half of a ``Problem``), and
  * the legacy string-dispatch front-ends (``squared_loss`` /
    ``lasso_loss`` / ``logistic_loss`` / ``empirical_error`` /
    ``make_prox``) as one-line adapters over the loss registry.

All node-local data is stored batched over nodes with padding:
X: (V, m_max, n), y: (V, m_max), sample_mask: (V, m_max).  Unlabeled
nodes (i not in M) have an identity primal update — implemented by
masking.  A batch of problems (``api.solver.solve_many``) stacks them
over a leading axis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class NodeData:
    """Batched local datasets X^(i) (padded over nodes).

    Attributes:
      x:            (V, m_max, n) feature vectors.
      y:            (V, m_max) labels (regression targets or {0,1}).
      sample_mask:  (V, m_max) 1.0 for real data points, 0.0 for padding.
      labeled_mask: (V,) 1.0 for i in the training set M (eq. 1), else 0.0.
    """

    x: torch.Tensor
    y: torch.Tensor
    sample_mask: torch.Tensor
    labeled_mask: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.x.shape[-3]

    @property
    def num_features(self) -> int:
        return self.x.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device) -> "NodeData":
        """The same data with its tensors on ``device``."""
        dev = resolve_device(device)
        return NodeData(*(t.to(dev) for t in (
            self.x, self.y, self.sample_mask, self.labeled_mask)))

    def counts(self) -> torch.Tensor:
        """(V,) effective m_i (>= 1 to avoid 0-division on empty nodes);
        (B, V) for stacked data."""
        return torch.clamp(torch.sum(self.sample_mask, dim=-1), min=1.0)


# ---------------------------------------------------------------------------
# Legacy adapters over the loss registry (repro_torch.api.losses owns the math)
# ---------------------------------------------------------------------------

def _resolve(loss: str, alpha: float = 0.0, num_inner: int = 50):
    """Map the historical string+kwargs dispatch onto a Loss instance."""
    from repro_torch.api.losses import get_loss

    if loss == "squared":
        return get_loss("squared")
    if loss == "lasso":
        return get_loss("lasso", alpha=alpha, num_inner=num_inner)
    if loss == "logistic":
        return get_loss("logistic", num_inner=min(num_inner, 12))
    raise ValueError(f"unknown loss {loss!r}")


def squared_loss(data: NodeData, w: torch.Tensor) -> torch.Tensor:
    """(1/m_i) sum_r (y_r - w^T x_r)^2 per node: (V,) (eq. 20)."""
    return _resolve("squared").node_values(data, w)


def lasso_loss(data: NodeData, w: torch.Tensor,
               alpha: float) -> torch.Tensor:
    """(1/m_i)||X w - y||^2 + alpha ||w||_1 per node: (V,) (eq. 22)."""
    return _resolve("lasso", alpha=alpha).node_values(data, w)


def logistic_loss(data: NodeData, w: torch.Tensor) -> torch.Tensor:
    """Per-node binary cross-entropy (eq. 23): (V,)."""
    return _resolve("logistic").node_values(data, w)


def empirical_error(data: NodeData, w: torch.Tensor, loss: str = "squared",
                    alpha: float = 0.0) -> torch.Tensor:
    """E_hat(w) = sum_{i in M} L(X^(i), w^(i))  (eq. 2)."""
    return _resolve(loss, alpha=alpha).empirical_error(data, w)


def make_prox(loss: str, data: NodeData, tau: torch.Tensor, *,
              alpha: float = 0.0, num_inner: int = 50,
              affine_fn: Callable | None = None):
    """Primal-update operator factory (one per paper §4.x variant);
    ``affine_fn`` routes the squared loss's affine map through a kernel
    (``kernels.ops.batched_affine``)."""
    return _resolve(loss, alpha=alpha, num_inner=num_inner).make_prox(
        data, tau, affine_fn=affine_fn)

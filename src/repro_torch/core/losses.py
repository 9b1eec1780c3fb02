"""Batched node-local datasets (the data half of a ``Problem``).

The loss numerics live in :mod:`repro_torch.api.losses`.  All node-local
data is stored batched over nodes with padding: X: (V, m_max, n),
y: (V, m_max), sample_mask: (V, m_max).  Unlabeled nodes (i not in M)
have an identity primal update — implemented by masking.  A batch of
problems (``api.solver.solve_many``) stacks them over a leading axis.
"""
from __future__ import annotations

import dataclasses

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

"""Pluggable local losses — the port's home of the loss numerics.

Paper §4: Algorithm 1 is a *template*; choosing the local loss
L(X^(i), w) fixes the node-wise primal update operator (eq. 18)

    PU_i(v) = argmin_z  L(X^(i), z) + (1/(2 tau_i)) ||v - z||^2 .

A :class:`Loss` bundles what the engine needs from that choice:
``node_values``, ``prox_setup`` (a flat dict of per-node (V, ...)
tensors, every leaf at least 2-D), ``prox_apply`` and ``make_prox`` —
the interface of ``repro.api.losses``.

This slice ports the squared error (eq. 20, closed-form ridge prox
eq. 21).  The lasso and logistic losses are registered names that raise
``NotImplementedError`` until their slice lands.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar

import torch

from repro_torch.core.losses import NodeData

LOSSES: dict[str, type] = {}

# registered in the reference, not yet in the port: name -> ROADMAP item
_PENDING_LOSSES = {
    "lasso": "ROADMAP.md Open items §1 item 2 (lasso prox) and §2 item 1 "
             "(the fused kernel's in-kernel lasso prox)",
    "logistic": "ROADMAP.md Open items §1 item 2 (logistic prox with "
                "_chol_solve) and §2 item 1 (the fused kernel's in-kernel "
                "logistic prox)",
}


def register_loss(name: str):
    """Class decorator adding a Loss subclass to the registry."""
    def deco(cls):
        cls.name = name
        LOSSES[name] = cls
        return cls
    return deco


def get_loss(spec, **kwargs) -> "Loss":
    """Resolve a Loss instance from an instance or a registry name."""
    if isinstance(spec, Loss):
        if kwargs:
            raise TypeError("loss kwargs only apply to registry names")
        return spec
    if isinstance(spec, str):
        if spec in _PENDING_LOSSES:
            raise NotImplementedError(
                f"loss {spec!r} is not ported yet: "
                f"{_PENDING_LOSSES[spec]}")
        try:
            cls = LOSSES[spec]
        except KeyError:
            raise ValueError(
                f"unknown loss {spec!r}; registered: {sorted(LOSSES)}")
        return cls(**kwargs)
    raise TypeError(f"loss must be a Loss or a registry name, got {spec!r}")


@dataclasses.dataclass(frozen=True)
class Loss:
    """Local loss interface (paper §4 template slot)."""

    name: ClassVar[str] = "base"
    # prox_apply runs inside the port's fused CUDA kernel
    kernel_safe: ClassVar[bool] = False

    def node_values(self, data: NodeData, w: torch.Tensor) -> torch.Tensor:
        """Per-node loss L(X^(i), w^(i)): (V,)."""
        raise NotImplementedError

    def empirical_error(self, data: NodeData,
                        w: torch.Tensor) -> torch.Tensor:
        """E_hat(w) = sum_{i in M} L(X^(i), w^(i))  (paper eq. 2)."""
        return torch.sum(self.node_values(data, w) * data.labeled_mask)

    def prox_setup(self, data: NodeData, tau: torch.Tensor) -> dict:
        """Precompute the batched primal-update parameters as a flat
        ``{name: (V, ...)}`` dict (every leaf ``ndim >= 2``)."""
        raise NotImplementedError

    def prox_apply(self, params: dict, v: torch.Tensor) -> torch.Tensor:
        """Evaluate PU (eq. 18) batched over nodes: (..., V, n) -> same."""
        raise NotImplementedError

    def prox_param_floats(self, num_samples: int, num_features: int) -> int:
        """Per-node float count of ``prox_setup`` leaves (layout sizing)."""
        raise NotImplementedError

    def make_prox(self, data: NodeData, tau: torch.Tensor) -> Callable:
        """Batched primal-update operator PU (eq. 18): (V, n) -> (V, n)."""
        params = self.prox_setup(data, tau)

        def prox(v: torch.Tensor) -> torch.Tensor:
            return self.prox_apply(params, v)

        return prox


@register_loss("squared")
@dataclasses.dataclass(frozen=True)
class SquaredLoss(Loss):
    """Squared error (paper §4.1, eq. 20) — closed-form ridge prox (eq. 21)."""

    kernel_safe: ClassVar[bool] = True

    def node_values(self, data, w):
        pred = torch.einsum("vmn,vn->vm", data.x, w)
        res = (data.y - pred) ** 2 * data.sample_mask
        return torch.sum(res, dim=1) / data.counts()

    def prox_setup(self, data, tau):
        """Precompute eq. 21 as an affine map.

        PU_i(v) = (I + (2 tau_i / m_i) Q_i)^{-1} (v + (2 tau_i / m_i)
        X_i^T y_i) with Q_i = X_i^T X_i; returns ``{"p": (V, n, n),
        "b": (V, n)}`` such that PU_i(v) = P_i @ (v + b_i).  Unlabeled
        nodes get P = I, b = 0.  The batched inverse is set-up work, once
        per solve (the reference leaves it to XLA's ``jnp.linalg.inv``).
        """
        xm = data.x * data.sample_mask[..., None]
        q = torch.einsum("vmn,vmk->vnk", xm, data.x)          # (V, n, n)
        xty = torch.einsum("vmn,vm->vn", xm, data.y)          # (V, n)
        c = (2.0 * tau / data.counts())[:, None]              # (V, 1)
        n = data.num_features
        eye = torch.eye(n, dtype=data.x.dtype, device=data.x.device)
        a = eye[None] + c[..., None] * q
        p = torch.linalg.inv(a)
        b = c * xty
        lab = data.labeled_mask
        p = torch.where(lab[:, None, None] > 0, p, eye[None])
        b = torch.where(lab[:, None] > 0, b, torch.zeros_like(b))
        return {"p": p, "b": b}

    def prox_apply(self, params, v):
        vb = v + params["b"]
        return torch.einsum("...nk,...k->...n", params["p"], vb)

    def prox_param_floats(self, num_samples, num_features):
        n = num_features
        return n * n + n

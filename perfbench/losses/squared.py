"""The squared loss: the paper's networked linear regression (§5)."""
from __future__ import annotations

import torch


def targets(x: torch.Tensor, w_true: torch.Tensor,
            gen: torch.Generator) -> torch.Tensor:
    """Noiseless targets x^T w."""
    return torch.einsum("...mn,...n->...m", x, w_true)


def drift(y: torch.Tensor, noise: float,
          gen: torch.Generator) -> torch.Tensor:
    """Targets plus Gaussian noise of standard deviation ``noise``."""
    if not noise:
        return y
    return y + noise * torch.randn(y.shape, generator=gen, device=y.device)


def prox_flops(n: int, m: int) -> int:
    """P (v + b)."""
    return 2 * n * n + n


def prox_floats(n: int, m: int) -> int:
    """P (n x n) and b (n)."""
    return n * n + n


class Prox:
    """Eq. 21's closed form: PU(v) = (I + c Q)^-1 (v + c X^T y) with
    Q = X^T X and c = 2 tau / m."""

    def __init__(self, x, y, tau):
        m = x.shape[1]
        c = 2.0 * tau / m
        q = torch.einsum("kmn,kml->knl", x, x)
        eye = torch.eye(x.shape[2], dtype=x.dtype, device=x.device)
        self.p = torch.linalg.inv(eye + c[..., None] * q)
        self.b = c * torch.einsum("kmn,km->kn", x, y)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return torch.einsum("knl,...kl->...kn", self.p, v + self.b)

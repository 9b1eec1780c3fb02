"""The logistic loss: the same federation as a classifier, labels
y ~ Bernoulli(sigmoid(x^T w)) as ``data/synthetic.py:
make_classification_data`` draws them."""
from __future__ import annotations

import torch


def targets(x: torch.Tensor, w_true: torch.Tensor,
            gen: torch.Generator) -> torch.Tensor:
    """Bernoulli labels of the true logits."""
    logits = torch.einsum("...mn,...n->...m", x, w_true)
    u = torch.rand(logits.shape, generator=gen, device=x.device)
    return (u < torch.sigmoid(logits)).to(torch.float32)


def drift(y: torch.Tensor, noise: float,
          gen: torch.Generator) -> torch.Tensor:
    """Redrawn labels carry their noise already."""
    return y


def prox_flops(n: int, m: int, num_inner: int = 8) -> int:
    """``num_inner`` Newton steps over m samples and an n x n solve."""
    per_sample = (2 * n          # logit
                  + 4            # sigmoid and residual
                  + 2 * n        # gradient
                  + 2            # Hessian weight
                  + n * (n + 1))   # Hessian, one triangle
    solve = n ** 3 // 3 + 2 * n * n + 4 * n   # Cholesky, solves, step
    return num_inner * (m * per_sample + solve)


def prox_floats(n: int, m: int) -> int:
    """The m samples and their labels."""
    return m * (n + 1)


class Prox:
    """argmin_z mean_j BCE(x_j^T z, y_j) + |z - v|^2 / (2 tau), by
    ``num_inner`` Newton steps from z = v (a fixed count, not an exact
    prox: the program's, whose default is 8)."""

    def __init__(self, x, y, tau, num_inner: int = 8):
        self.x, self.y, self.tau = x, y, tau
        self.m = x.shape[1]
        self.num_inner = int(num_inner)

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        x, y, m, tau = self.x, self.y, self.m, self.tau
        n = v.shape[-1]
        eye = torch.eye(n, dtype=v.dtype, device=v.device)
        xx = x[..., :, None] * x[..., None, :]          # (K, m, n, n)
        z = v
        for _ in range(self.num_inner):
            s = torch.sigmoid((x * z[..., None, :]).sum(-1))
            grad = ((s - y)[..., None] * x).sum(-2) / m + (z - v) / tau
            d = s * (1.0 - s)
            hess = ((d[..., None, None] * xx).sum(-3) / m
                    + eye / tau[..., None])
            z = z - torch.linalg.solve(hess, grad.unsqueeze(-1))[..., 0]
        return z

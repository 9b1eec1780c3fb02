"""Pluggable local losses — the port's home of the loss numerics.

Paper §4: Algorithm 1 is a *template*; choosing the local loss
L(X^(i), w) fixes the node-wise primal update operator (eq. 18)

    PU_i(v) = argmin_z  L(X^(i), z) + (1/(2 tau_i)) ||v - z||^2 .

A :class:`Loss` bundles what the engine needs from that choice:
``node_values``, ``prox_setup`` (a flat dict of per-node (V, ...)
tensors, every leaf at least 2-D), ``prox_apply`` and ``make_prox`` —
the interface of ``repro.api.losses``.

Implemented losses (paper §4.1-4.3):
  * squared error (eq. 20)   -> closed-form batched ridge solve (eq. 21),
  * Lasso (eq. 22)           -> ISTA inner loop (high-dim m_i << n regime),
  * logistic (eq. 23)        -> damped-Newton inner loop (no closed form),
                                solved by the unrolled small-n Cholesky.

``prox_apply`` takes any leading axes (``...``), so the same code runs on
the dense (V, n) state, a lambda path's lane-stacked (L, V, n) state
(parameters shared by every lane broadcast) and the fused plain
version's (B, NW, n) windows.  ``prox_setup`` takes data stacked over a
leading batch axis too (``solve_many``), giving (B, V, ...) leaves.
``kernel_safe`` means the loss's prox runs inside the port's CUDA
``fused_pd_step``: all three registered losses do, as in the
reference, so each of them fuses on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar

import torch

from repro_torch.core.graph import ordered_sum
from repro_torch.core.losses import NodeData

LOSSES: dict[str, type] = {}

# nodes per batched eigvalsh call of the lasso's set-up: on the H100
# (CUDA 12.8) cuSOLVER's batched eigensolver takes 16384 4x4 matrices
# and refuses 32768 (CUSOLVER_STATUS_INVALID_VALUE)
EIGVALSH_BATCH = 1 << 14


def register_loss(name: str):
    """Class decorator adding a Loss subclass to the registry."""
    def deco(cls):
        cls.name = name
        LOSSES[name] = cls
        return cls
    return deco


def get_loss(spec, **kwargs) -> "Loss":
    """Resolve a Loss instance from an instance or a registry name.

    Extra keyword arguments configure the loss when ``spec`` is a name
    (e.g. ``get_loss("lasso", alpha=0.02)``).
    """
    if isinstance(spec, Loss):
        if kwargs:
            raise TypeError("loss kwargs only apply to registry names")
        return spec
    if isinstance(spec, str):
        try:
            cls = LOSSES[spec]
        except KeyError:
            raise ValueError(
                f"unknown loss {spec!r}; registered: {sorted(LOSSES)}")
        return cls(**kwargs)
    raise TypeError(f"loss must be a Loss or a registry name, got {spec!r}")


def _soft_threshold(z: torch.Tensor, t) -> torch.Tensor:
    return torch.sign(z) * torch.clamp(torch.abs(z) - t, min=0.0)


#: the widest system :func:`_chol_solve` unrolls (the fused kernel's
#: register tile): its ops grow as n^3, so wider ones factor in one call
UNROLLED_CHOLESKY = 16


def _chol_solve(a: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve via an explicit unrolled Cholesky factorization.

    ``a`` (..., n, n) symmetric positive definite, ``rhs`` (..., n) ->
    (..., n) solving ``a @ z = rhs`` per node.  Up to
    ``UNROLLED_CHOLESKY`` features the Cholesky-Banachiewicz recurrence
    and the two triangular substitutions are Python loops of elementwise
    arithmetic over the node axes, as in the reference; past it the
    n^3 / 3 elementwise ops of that recurrence would be as many launches
    on the card, so the factorization and the solves are one batched
    call each (``cholesky_ex``: no status read on the host).
    """
    n = a.shape[-1]
    if n > UNROLLED_CHOLESKY:
        lo, _ = torch.linalg.cholesky_ex(a)
        return torch.cholesky_solve(rhs[..., None], lo)[..., 0]
    lo = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - lo[i][k] * lo[j][k]
            lo[i][j] = torch.sqrt(s) if i == j else s / lo[j][j]
    # forward substitution  L c = rhs
    c = [None] * n
    for i in range(n):
        s = rhs[..., i]
        for k in range(i):
            s = s - lo[i][k] * c[k]
        c[i] = s / lo[i][i]
    # back substitution  L^T z = c
    z = [None] * n
    for i in reversed(range(n)):
        s = c[i]
        for k in range(i + 1, n):
            s = s - lo[k][i] * z[k]
        z[i] = s / lo[i][i]
    return torch.stack(z, dim=-1)


def feature_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Every sample's prediction x_j^T w_i: x (..., V, m, n) against w
    (..., V, n) -> (..., V, m), a feature at a time (a multiply, then an
    add, each exactly rounded), so a lane's predictions are the same bits
    whatever the lane count (a batched matrix product picks its order
    from the shape)."""
    pred = x[..., 0] * w[..., None, 0]
    for k in range(1, x.shape[-1]):
        pred = pred + x[..., k] * w[..., None, k]
    return pred


@dataclasses.dataclass(frozen=True)
class Loss:
    """Local loss interface (paper §4 template slot)."""

    name: ClassVar[str] = "base"
    # prox_apply runs inside the port's fused CUDA kernel
    kernel_safe: ClassVar[bool] = False

    def node_values(self, data: NodeData, w: torch.Tensor) -> torch.Tensor:
        """Per-node loss L(X^(i), w^(i)): (V,); w (..., V, n) with lanes
        gives (..., V), data shared by the lanes or stacked with them."""
        raise NotImplementedError

    def empirical_error(self, data: NodeData,
                        w: torch.Tensor) -> torch.Tensor:
        """E_hat(w) = sum_{i in M} L(X^(i), w^(i))  (paper eq. 2); () for
        w (V, n), (L,) for lanes (L, V, n).  Summed in
        :func:`~repro_torch.core.graph.ordered_sum`'s order, so each lane
        gives the bits of its own evaluation."""
        return ordered_sum(self.node_values(data, w) * data.labeled_mask, -1)

    def prox_setup(self, data: NodeData, tau: torch.Tensor) -> dict:
        """Precompute the batched primal-update parameters as a flat
        ``{name: (V, ...)}`` dict (every leaf ``ndim >= 2``)."""
        raise NotImplementedError

    def prox_apply(self, params: dict, v: torch.Tensor, *,
                   affine_fn: Callable | None = None) -> torch.Tensor:
        """Evaluate PU (eq. 18) batched over nodes: (..., V, n) -> same.

        ``affine_fn(p, v)`` routes affine-map losses through the
        ``batched_affine`` kernel; iterative losses ignore it.
        """
        raise NotImplementedError

    def prox_param_floats(self, num_samples: int, num_features: int) -> int:
        """Per-node float count of ``prox_setup`` leaves (layout sizing)."""
        raise NotImplementedError

    def make_prox(self, data: NodeData, tau: torch.Tensor, *,
                  affine_fn: Callable | None = None) -> Callable:
        """Batched primal-update operator PU (eq. 18): (V, n) -> (V, n)."""
        params = self.prox_setup(data, tau)

        def prox(v: torch.Tensor) -> torch.Tensor:
            return self.prox_apply(params, v, affine_fn=affine_fn)

        return prox


@register_loss("squared")
@dataclasses.dataclass(frozen=True)
class SquaredLoss(Loss):
    """Squared error (paper §4.1, eq. 20) — closed-form ridge prox (eq. 21)."""

    kernel_safe: ClassVar[bool] = True

    def node_values(self, data, w):
        pred = feature_dot(data.x, w)
        res = (data.y - pred) ** 2 * data.sample_mask
        return ordered_sum(res, -1) / data.counts()

    def prox_setup(self, data, tau):
        """Precompute eq. 21 as an affine map.

        PU_i(v) = (I + (2 tau_i / m_i) Q_i)^{-1} (v + (2 tau_i / m_i)
        X_i^T y_i) with Q_i = X_i^T X_i; returns ``{"p": (V, n, n),
        "b": (V, n)}`` such that PU_i(v) = P_i @ (v + b_i).  Unlabeled
        nodes get P = I, b = 0.  The batched inverse is set-up work, once
        per solve (the reference leaves it to XLA's ``jnp.linalg.inv``).
        """
        xm = data.x * data.sample_mask[..., None]
        q = torch.einsum("...vmn,...vmk->...vnk", xm, data.x)  # (V, n, n)
        xty = torch.einsum("...vmn,...vm->...vn", xm, data.y)  # (V, n)
        c = (2.0 * tau / data.counts())[..., None]             # (V, 1)
        n = data.num_features
        eye = torch.eye(n, dtype=data.x.dtype, device=data.x.device)
        a = eye + c[..., None] * q
        # inv_ex: the same inverse without the host-side check of its
        # info code, so set-up on the card never synchronizes
        p = torch.linalg.inv_ex(a).inverse
        b = c * xty
        lab = data.labeled_mask
        # row-major, as the batched_affine kernel reads it (the batched
        # inverse on CUDA comes back column-major per matrix)
        p = torch.where(lab[..., None, None] > 0, p, eye).contiguous()
        b = torch.where(lab[..., None] > 0, b, torch.zeros_like(b))
        return {"p": p, "b": b}

    def prox_apply(self, params, v, *, affine_fn=None):
        vb = v + params["b"]
        if affine_fn is not None:
            return affine_fn(params["p"], vb)
        return torch.einsum("...nk,...k->...n", params["p"], vb)

    def prox_param_floats(self, num_samples, num_features):
        n = num_features
        return n * n + n


@register_loss("lasso")
@dataclasses.dataclass(frozen=True)
class LassoLoss(Loss):
    """Lasso (paper §4.2, eq. 22) — ISTA inner loop for the m_i << n regime.

    ``alpha`` is the local l1 weight (lambda inside eq. 22; renamed to
    avoid clashing with the TV strength).  The smooth part has per-node
    Lipschitz constant L_i = 2 lambda_max(Q_i)/m_i + 1/tau_i; ISTA takes
    steps 1/L_i and soft-thresholds with alpha/L_i.
    """

    alpha: float = 0.0
    num_inner: int = 50

    # the fused CUDA kernel runs the ISTA prox (its params are the sorted
    # keys below, plus alpha and num_inner)
    kernel_safe: ClassVar[bool] = True

    def node_values(self, data, w):
        return (SquaredLoss().node_values(data, w)
                + self.alpha * ordered_sum(torch.abs(w), -1))

    def prox_setup(self, data, tau):
        xm = data.x * data.sample_mask[..., None]
        q = torch.einsum("...vmn,...vmk->...vnk", xm, data.x)
        xty = torch.einsum("...vmn,...vm->...vn", xm, data.y)
        m = data.counts()
        # lambda_max via eigvalsh (set-up only; n is small), in batches
        # of EIGVALSH_BATCH nodes over every problem of a stacked batch
        n = q.shape[-1]
        lam_max = torch.cat([torch.linalg.eigvalsh(c)[:, -1]
                             for c in q.reshape(-1, n, n).split(
                                 EIGVALSH_BATCH)]).reshape(q.shape[:-2])
        lips = 2.0 * lam_max / m + 1.0 / tau                  # (V,)
        return {"q": q, "xty": xty, "m": m[..., None],
                "step": (1.0 / lips)[..., None], "tau": tau[..., None],
                "labeled": data.labeled_mask[..., None]}

    def prox_apply(self, params, v, *, affine_fn=None):
        del affine_fn                       # iterative inner solver
        q, xty = params["q"], params["xty"]
        m, step, tau = params["m"], params["step"], params["tau"]
        z = v
        for _ in range(self.num_inner):
            grad = 2.0 * (torch.einsum("...nk,...k->...n", q, z) - xty) / m
            grad = grad + (z - v) / tau
            z = _soft_threshold(z - step * grad, self.alpha * step)
        return torch.where(params["labeled"] > 0, z, v)

    def prox_param_floats(self, num_samples, num_features):
        n = num_features
        return n * n + n + 4


@register_loss("logistic")
@dataclasses.dataclass(frozen=True)
class LogisticLoss(Loss):
    """Logistic (paper §4.3, eq. 23) — damped-Newton inner loop.

    The objective  L_i(z) + (1/(2 tau_i))||z - v||^2  is smooth and
    strongly convex; n is small, so a handful of exact Newton steps
    converge.  The Newton system ``H + I/tau`` is SPD by construction and
    is solved by the explicit small-n Cholesky (:func:`_chol_solve`).
    """

    num_inner: int = 8

    # the fused CUDA kernel runs the Newton prox with the unrolled
    # Cholesky (its params are the sorted keys below, plus num_inner; the
    # sample count is x.shape[1])
    kernel_safe: ClassVar[bool] = True

    def node_values(self, data, w):
        logits = feature_dot(data.x, w)
        # numerically-stable BCE with logits
        per = (torch.clamp(logits, min=0.0) - logits * data.y
               + torch.log1p(torch.exp(-torch.abs(logits))))
        return ordered_sum(per * data.sample_mask, -1) / data.counts()

    def prox_setup(self, data, tau):
        return {"x": data.x, "y": data.y, "mask": data.sample_mask,
                "m": data.counts()[..., None], "tau": tau[..., None],
                "labeled": data.labeled_mask[..., None]}

    def prox_apply(self, params, v, *, affine_fn=None):
        del affine_fn                       # iterative inner solver
        x, y, mask = params["x"], params["y"], params["mask"]
        m, tau = params["m"], params["tau"]
        n = v.shape[-1]
        eye = torch.eye(n, dtype=v.dtype, device=v.device)
        z = v
        for _ in range(self.num_inner):
            logits = torch.einsum("...mn,...n->...m", x, z)
            s = torch.sigmoid(logits)
            r = (s - y) * mask                                   # (..., m)
            grad = torch.einsum("...m,...mn->...n", r, x) / m
            grad = grad + (z - v) / tau
            d = (s * (1 - s)) * mask                             # (..., m)
            hess = (torch.einsum("...m,...mn,...mk->...nk", d, x, x)
                    / m[..., None])
            hess = hess + eye / tau[..., None]
            z = z - _chol_solve(hess, grad)
        return torch.where(params["labeled"] > 0, z, v)

    def prox_param_floats(self, num_samples, num_features):
        return num_samples * (num_features + 2) + 3


@dataclasses.dataclass(frozen=True)
class CallableLoss(Loss):
    """Adapter for caller-supplied prox operators (legacy entry points).

    Wraps an externally-built ``prox(v)`` while delegating metric values to
    ``base``.  Not registered — exists so ``core.nlasso.solve_nlasso`` can
    keep accepting arbitrary prox callables through the solver.  No
    ``prox_setup``: the fused kernel cannot take an opaque callable, so
    the pallas backend runs it on the unfused path, and the sharded
    backends refuse it.
    """

    prox_fn: Callable = None
    base: Loss = None

    def node_values(self, data, w):
        return self.base.node_values(data, w)

    def make_prox(self, data, tau, *, affine_fn=None):
        return self.prox_fn

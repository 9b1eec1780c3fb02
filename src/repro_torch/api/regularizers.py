"""Pluggable edge-coupling regularizers — generalizing the TV penalty.

The paper couples local models with the TV seminorm lambda * ||w||_TV
(eq. 3-4); GTVMin replaces it by a general penalty lambda * g(D w).
A :class:`Regularizer` supplies the three pieces Algorithm 1 needs:
``value``, ``dual_prox`` (the resolvent of sigma * dg*, step 10) and
``project_dual`` — the interface of ``repro.api.regularizers``.

``dual_prox`` and ``project_dual`` also take lane-stacked duals u (L, E,
n) with one lambda per lane, ``lam`` an (L, 1) tensor, against shared
weights (E,) or per-lane weights (L, E): a lambda path or a batch of
problems (the reference vmaps them).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar

import torch

from repro_torch.core.graph import ordered_sum
from repro_torch.engine.step import ensure_column as _col

REGULARIZERS: dict[str, type] = {}


def register_regularizer(name: str):
    """Class decorator adding a Regularizer subclass to the registry."""
    def deco(cls):
        cls.name = name
        REGULARIZERS[name] = cls
        return cls
    return deco


def get_regularizer(spec, **kwargs) -> "Regularizer":
    """Resolve a Regularizer from an instance or a registry name."""
    if isinstance(spec, Regularizer):
        if kwargs:
            raise TypeError("regularizer kwargs only apply to registry names")
        return spec
    if isinstance(spec, str):
        try:
            cls = REGULARIZERS[spec]
        except KeyError:
            raise ValueError(f"unknown regularizer {spec!r}; "
                             f"registered: {sorted(REGULARIZERS)}")
        return cls(**kwargs)
    raise TypeError(
        f"regularizer must be a Regularizer or a registry name, got {spec!r}")


def _edge_col(level: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Per-edge levels (..., E) as a column against ``u`` (..., E, n);
    levels that already carry the column pass through."""
    return level[..., None] if level.ndim < u.ndim else level


def _clip(u: torch.Tensor, bound: torch.Tensor,
          clip_fn: Callable | None = None) -> torch.Tensor:
    """Edge-wise clip to +-bound (``jnp.clip(u, -b, b)``); ``clip_fn(u,
    bound)`` routes it through a kernel (``kernels.ops.tv_prox``)."""
    if clip_fn is not None:
        return clip_fn(u, bound)
    b = _edge_col(bound, u)
    return torch.minimum(torch.maximum(u, -b), b)


@dataclasses.dataclass(frozen=True)
class Regularizer:
    """Edge-coupling penalty lam * g(D w) (GTVMin template slot).

    ``dual_prox`` / ``project_dual`` receive either an
    :class:`~repro_torch.core.graph.EmpiricalGraph` or an engine executor
    as ``graph`` — both expose ``weights``, which is all the resolvents
    read.  ``fusable`` marks regularizers whose resolvent is elementwise
    in the owned edge rows (the fused kernel's edge phase).
    """

    name: ClassVar[str] = "base"
    fusable: ClassVar[bool] = False

    def value(self, graph, w: torch.Tensor, lam) -> torch.Tensor:
        raise NotImplementedError

    def lane_value(self, d: torch.Tensor, weights: torch.Tensor,
                   lam: torch.Tensor) -> torch.Tensor:
        """:meth:`value` of every lane from its edge differences ``d`` =
        D w (L, E, n), the edge weights (E,) or (L, E) and ``lam`` (L,):
        (L,), summed in ``core.graph.ordered_sum``'s order."""
        raise NotImplementedError

    def dual_prox(self, u: torch.Tensor, graph, lam, sigma, *,
                  clip_fn: Callable | None = None) -> torch.Tensor:
        """Resolvent of sigma * dg* at ``u`` (dual update, step 10)."""
        raise NotImplementedError

    def project_dual(self, u: torch.Tensor, graph, lam, *,
                     clip_fn: Callable | None = None) -> torch.Tensor:
        """Projection onto dom g* (identity when unbounded)."""
        return u

    def dual_infeasibility(self, u: torch.Tensor, graph,
                           lam) -> torch.Tensor:
        """max violation of the dual constraint (<= 0 means feasible)."""
        return torch.zeros((), dtype=torch.float32, device=u.device)


@register_regularizer("tv")
@dataclasses.dataclass(frozen=True)
class TotalVariation(Regularizer):
    """lam * sum_e A_e ||w^(i) - w^(j)||_1 — the paper's TV penalty (eq. 3).

    g* is the indicator of the box {|u_j^(e)| <= lam A_e}, so both the
    dual prox and the dual projection are the edge-wise clip
    T^(lam A_e) (Algorithm 1 step 10).  ``clip_fn(u, bound)`` may route
    it through the ``tv_prox`` kernel.
    """

    fusable: ClassVar[bool] = True

    def value(self, graph, w, lam):
        return lam * graph.total_variation(w)

    def lane_value(self, d, weights, lam):
        return lam * ordered_sum(weights * ordered_sum(torch.abs(d), -1), -1)

    def dual_prox(self, u, graph, lam, sigma, *, clip_fn=None):
        return _clip(u, lam * graph.weights, clip_fn)

    def project_dual(self, u, graph, lam, *, clip_fn=None):
        return _clip(u, lam * graph.weights, clip_fn)

    def dual_infeasibility(self, u, graph, lam):
        return torch.max(torch.abs(u) - lam * graph.weights[:, None])


@register_regularizer("tv2")
@dataclasses.dataclass(frozen=True)
class SquaredTV(Regularizer):
    """(lam/2) * sum_e A_e ||w^(i) - w^(j)||_2^2 — GTVMin quadratic coupling.

    Per edge g*_e(u) = ||u||^2 / (2 lam A_e), so the dual prox is the
    scaling u * lam A_e / (lam A_e + sigma_e); dom g* is unbounded, so
    the dual projection is the identity.
    """

    fusable: ClassVar[bool] = True

    def value(self, graph, w, lam):
        d = graph.incidence_apply(w)
        return 0.5 * lam * torch.sum(graph.weights * torch.sum(d * d, dim=1))

    def lane_value(self, d, weights, lam):
        return 0.5 * lam * ordered_sum(weights * ordered_sum(d * d, -1), -1)

    def dual_prox(self, u, graph, lam, sigma, *, clip_fn=None):
        del clip_fn                         # a scaling, not a clip
        la = _edge_col(lam * graph.weights, u)
        return u * (la / (la + _col(sigma)))

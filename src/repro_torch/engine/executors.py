"""The port's realizations of the engine's :class:`GraphExecutor`.

  * :class:`DenseExecutor`  — padded incidence-table gather-sum over the
    whole graph (the dense backend),
  * :class:`BatchedDenseExecutor` — the same over a leading lane axis:
    a lambda path on one graph, or a batch of graphs of one shape (the
    reference vmaps the dense executor),
  * :class:`WindowExecutor` — the windows of the edge-blocked layout
    (the fused kernel's plain version, ``kernels.ref``),
  * :class:`MailboxExecutor` — the federated runtime's per-edge message
    protocol: duals read through owner broadcasts, primal differences
    through persistent (optionally compressed) mailboxes.

Executors also stand in for the graph inside the regularizer resolvents:
``weights`` is the per-owned-edge A_e in the executor's own edge order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.graph import (batched_incidence_apply,
                                    batched_incidence_transpose_apply)
from repro_torch.obs import profile as _prof
from repro_torch.obs.profile import annotate as _scope


@dataclasses.dataclass(frozen=True)
class DenseExecutor:
    """Single-device executor over an :class:`EmpiricalGraph`."""

    graph: Any

    @property
    def weights(self) -> torch.Tensor:
        return self.graph.weights

    def gather_duals(self, u: torch.Tensor) -> torch.Tensor:
        return self.graph.incidence_transpose_apply(u)

    def edge_diff(self, z: torch.Tensor) -> torch.Tensor:
        return self.graph.incidence_apply(z)

    def owned_duals(self, u: torch.Tensor) -> torch.Tensor:
        return u


@dataclasses.dataclass(frozen=True)
class BatchedDenseExecutor:
    """The dense executor over a leading lane axis L: the state is (L, V,
    n) / (L, E, n).  The graph arrays are one graph's, shared by every
    lane (``shared``: a lambda path), or carry the lane axis
    (``stacked``: ``solve_many``'s graphs, which share a shape but not a
    structure).  ``weights`` is (E,) or (L, E)."""

    src: torch.Tensor
    dst: torch.Tensor
    weights: torch.Tensor
    inc_edges: torch.Tensor
    inc_signs: torch.Tensor

    @classmethod
    def shared(cls, graph) -> "BatchedDenseExecutor":
        return cls(graph.src, graph.dst, graph.weights, graph.inc_edges,
                   graph.inc_signs)

    @classmethod
    def stacked(cls, graphs) -> "BatchedDenseExecutor":
        return cls(*(torch.stack([getattr(g, k) for g in graphs])
                     for k in ("src", "dst", "weights", "inc_edges",
                               "inc_signs")))

    def gather_duals(self, u: torch.Tensor) -> torch.Tensor:
        return batched_incidence_transpose_apply(self.inc_edges,
                                                 self.inc_signs, u)

    def edge_diff(self, z: torch.Tensor) -> torch.Tensor:
        return batched_incidence_apply(self.src, self.dst, z)

    def owned_duals(self, u: torch.Tensor) -> torch.Tensor:
        return u


@dataclasses.dataclass(frozen=True)
class WindowExecutor:
    """The windows of the edge-blocked layout (``EdgeBlockLayout``),
    stacked over a leading block axis B.

    The reference vmaps one window over the blocks; here the block axis
    is written out.  ``w`` is the (B, NW, n) node windows (owned + halo
    blocks), the gather-side dual state is the (B, EW, n) edge windows,
    and each window *owns* the (EB, n) rows at offset ``klo * EB``
    inside it.  ``inc_local`` holds window-relative edge ids
    (pre-clipped), ``src_local`` / ``dst_local`` window-relative node ids
    per owned edge.  ``weights`` carries the already lambda-scaled clip
    levels ``lam * A_e`` for the owned edges, so the canonical step is
    invoked with ``lam = 1.0``.
    """

    inc_local: torch.Tensor     # (B, NW, max_deg) window-relative edge ids
    inc_signs: torch.Tensor     # (B, NW, max_deg) +1 / -1 / 0
    src_local: torch.Tensor     # (B, EB) window-relative src node ids
    dst_local: torch.Tensor     # (B, EB) window-relative dst node ids
    weights: torch.Tensor       # (B, EB, 1) lam * A_e per owned edge
    klo: int
    block_edges: int

    def _rows(self, a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """Per-block row gather: a (B, R, n), idx (B, ...) -> (B, ..., n)."""
        b = torch.arange(a.shape[0], device=a.device).reshape(
            (-1,) + (1,) * (idx.ndim - 1))
        return a[b, idx]

    def gather_duals(self, u: torch.Tensor) -> torch.Tensor:
        gathered = self._rows(u, self.inc_local)     # (B, NW, max_deg, n)
        return torch.einsum("bvd,bvdn->bvn", self.inc_signs, gathered)

    def edge_diff(self, z: torch.Tensor) -> torch.Tensor:
        return self._rows(z, self.src_local) - self._rows(z, self.dst_local)

    def owned_duals(self, u: torch.Tensor) -> torch.Tensor:
        eb = self.block_edges
        return u[:, self.klo * eb:(self.klo + 1) * eb]


class MailboxExecutor:
    """Federated message-passing executor (one communication round).

    Duals are gathered from owned rows plus the owner-broadcast mirrors
    ``u_recv`` (stale while the owner sleeps); the edge difference runs
    through the persistent primal mailboxes: active dst endpoints post a
    (compressed) copy of their operand ``z`` up to the edge owner, and
    the difference is formed against the mailbox content.  The refreshed
    mailbox state is left on ``z_recv_new`` for the round protocol to
    carry forward — an executor is built fresh each round.

    The gather is :meth:`DenseExecutor.gather_duals`'s (the padded
    table's gather and one einsum over it), with the owner-side select
    in between, so a synchronous round sums in the dense step's order;
    no op of a round accumulates with atomics, so a round is
    deterministic on the card too.
    """

    def __init__(self, graph, u_recv, z_recv, pos_signs, active_dst,
                 compress: Callable):
        self.graph = graph
        self.u_recv = u_recv
        self.z_recv = z_recv
        self.pos_signs = pos_signs          # (V, max_deg, 1) owner-side mask
        self.active_dst = active_dst        # (E, 1) bool
        self.compress = compress
        self.z_recv_new = None

    @property
    def weights(self) -> torch.Tensor:
        return self.graph.weights

    def gather_duals(self, u: torch.Tensor) -> torch.Tensor:
        g = self.graph
        gathered = torch.where(self.pos_signs, u[g.inc_edges],
                               self.u_recv[g.inc_edges])
        return torch.einsum("vd,vdn->vn", g.inc_signs, gathered)

    def edge_diff(self, z: torch.Tensor) -> torch.Tensor:
        with _scope(_prof.PHASE_MAILBOX_DIFF):
            g = self.graph
            self.z_recv_new = torch.where(self.active_dst,
                                          self.compress(z[g.dst]),
                                          self.z_recv)
            return z[g.src] - self.z_recv_new

    def owned_duals(self, u: torch.Tensor) -> torch.Tensor:
        return u

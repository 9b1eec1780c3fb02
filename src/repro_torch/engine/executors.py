"""The port's realizations of the engine's :class:`GraphExecutor`.

  * :class:`DenseExecutor`  — padded incidence-table gather-sum over the
    whole graph (the dense backend),
  * :class:`BatchedDenseExecutor` — the same over a leading lane axis:
    a lambda path on one graph, or a batch of graphs of one shape (the
    reference vmaps the dense executor),
  * :class:`WindowExecutor` — the windows of the edge-blocked layout
    (the fused kernel's plain version, ``kernels.ref``),
  * :class:`HaloExecutor`   — one shard of a partitioned graph on a rank
    of a mesh (``core.mesh``): D / D^T through collectives (a dense
    all-gather / all-reduce, or boundary rows only),
  * :class:`HierarchicalExecutor` — one shard of the two-level layout:
    the fused kernel steps the shard, and the executor refreshes the
    duals of replicated edges from their owners between steps,
  * :class:`MailboxExecutor` — the federated runtime's per-edge message
    protocol: duals read through owner broadcasts, primal differences
    through persistent (optionally compressed) mailboxes.

Executors also stand in for the graph inside the regularizer resolvents:
``weights`` is the per-owned-edge A_e in the executor's own edge order.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
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


@dataclasses.dataclass(frozen=True)
class HaloExecutor:
    """One shard of a :class:`~repro_torch.core.partition.PartitionPlan`
    on one rank of a mesh: the shard owns ``vp`` nodes (global rows
    ``[base, base + vp)`` of the plan's layout) and the edges whose src
    endpoint it owns; D / D^T become lock-step collectives over ``axis``.

    ``comm`` selects the exchange (the reference's two modes):

      * ``dense`` all-gathers the primal block and all-reduces (SUM) the
        dense (V_pad, n) D^T u accumulator;
      * ``boundary`` exchanges only boundary rows (nodes touching a cut
        edge): each shard publishes its own, padded to the largest
        count (``send_idx``), for D w, and the SUM runs over the (B, n)
        rows of the B boundary nodes (``bnd_rows``) for D^T u.  Rows of
        other shards that no cut edge touches are never read.

    On a one-rank axis every collective is the identity.  Index tables
    are built once per solve by :meth:`for_shard`.
    """

    mesh: Any
    axis: str
    comm: str
    vp: int
    v_pad: int
    base: int                   # this shard's first global row
    src: torch.Tensor           # (ep,) global node ids of owned edges
    dst: torch.Tensor
    weights: torch.Tensor       # (ep,) A_e (0 for padded edge slots)
    send_idx: torch.Tensor      # (B_max,) local boundary rows to publish
    recv_rows: torch.Tensor     # (k,) global rows of the published rows
    recv_pos: torch.Tensor      # (k,) their rows in the gathered buffer
    bnd_rows: torch.Tensor      # (B,) global boundary rows
    own_bnd: torch.Tensor       # this shard's boundary rows, local ...
    own_bnd_pos: torch.Tensor   # ... and their positions in bnd_rows

    @classmethod
    def for_shard(cls, mesh, axis: str, comm: str, *, shard: int, vp: int,
                  send_full: np.ndarray, src, dst, weights
                  ) -> "HaloExecutor":
        """The executor of shard ``shard``; ``send_full`` is the plan's
        (S * vp,) boundary mask (every shard's), ``src`` / ``dst`` /
        ``weights`` the shard's owned edges."""
        dev = src.device
        mask = np.asarray(send_full) > 0
        num_shards = len(mask) // vp
        local = [np.flatnonzero(mask[s * vp:(s + 1) * vp])
                 for s in range(num_shards)]
        width = max(max(len(ix) for ix in local), 1)
        pos = np.concatenate([s * width + np.arange(len(ix))
                              for s, ix in enumerate(local)])
        rows = np.concatenate([s * vp + ix for s, ix in enumerate(local)])
        send = np.zeros(width, np.int64)
        send[:len(local[shard])] = local[shard]
        bnd = np.flatnonzero(mask)
        own = (bnd >= shard * vp) & (bnd < (shard + 1) * vp)

        def index(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        return cls(mesh=mesh, axis=axis, comm=comm, vp=vp,
                   v_pad=num_shards * vp, base=shard * vp,
                   src=src.long(), dst=dst.long(), weights=weights,
                   send_idx=index(send), recv_rows=index(rows),
                   recv_pos=index(pos), bnd_rows=index(bnd),
                   own_bnd=index(bnd[own] - shard * vp),
                   own_bnd_pos=index(np.flatnonzero(own)))

    def gather_duals(self, u_loc: torch.Tensor) -> torch.Tensor:
        """All-shards-summed D^T u, returning the local (vp, n) block."""
        with _scope(_prof.PHASE_HALO_GATHER):
            acc = u_loc.new_zeros((self.v_pad, u_loc.shape[1]))
            acc.index_add_(0, self.src, u_loc)
            acc.index_add_(0, self.dst, -u_loc)
            if self.comm == "dense":
                tot = self.mesh.all_reduce(acc, "sum", self.axis)
                return tot[self.base:self.base + self.vp]
            # shard-internal rows stay local; boundary rows take the sum
            summed = self.mesh.all_reduce(acc[self.bnd_rows], "sum",
                                          self.axis)
            own = acc[self.base:self.base + self.vp]
            own[self.own_bnd] = summed[self.own_bnd_pos]
            return own

    def edge_diff(self, z_loc: torch.Tensor) -> torch.Tensor:
        with _scope(_prof.PHASE_HALO_DIFF):
            if self.comm == "dense":
                zg = self.mesh.all_gather(z_loc, self.axis)
            else:
                # remote rows: the published boundary rows (others are
                # never read); own rows: the exact local block
                gathered = self.mesh.all_gather(z_loc[self.send_idx],
                                                self.axis)
                zg = z_loc.new_zeros((self.v_pad, z_loc.shape[1]))
                zg[self.recv_rows] = gathered[self.recv_pos]
                zg[self.base:self.base + self.vp] = z_loc
            return zg[self.src] - zg[self.dst]

    def owned_duals(self, u: torch.Tensor) -> torch.Tensor:
        return u


@dataclasses.dataclass(frozen=True)
class HierarchicalExecutor:
    """One shard of the two-level layout
    (:class:`~repro_torch.core.partition.HierarchyPlan`): the fused
    kernel (``kernels.ops.pd_step``) steps the shard's local edge-blocked
    layout, and between steps this executor refreshes the duals of the
    replicated (non-owned) local edges from their owners — the only
    exchange the fused step needs to stay exact on owned state (the
    local subgraph is the 1-hop halo closure of the owned nodes: halo
    primal updates are recomputed redundantly, and the replicated duals
    a step computes are overwritten by the next refresh).

    ``comm`` selects the exchange payload: ``boundary`` all-gathers a
    compacted per-owner send list (NS rows a shard), ``dense`` the whole
    owned dual slab (NE rows a shard).  ``recv_slots`` are the
    replicated slots of this shard, ``recv_src`` their rows in the
    gathered buffer for the chosen mode, ``recv_flip`` the orientation
    into the local layout (exchange buffers travel in global
    orientation).  All tables are this shard's rows of the stacked plan.
    """

    mesh: Any
    axis: str
    comm: str
    num_blocks: int
    block_nodes: int
    block_edges: int
    klo: int
    node_owned: torch.Tensor    # (NV, 1) residual mask over layout nodes
    edge_owned: torch.Tensor    # (NE, 1) 1.0 where this shard owns the edge
    orient: torch.Tensor        # (NE, 1) u_layout = orient * u_global
    send_idx: torch.Tensor      # (NS,) owned slots to publish (boundary)
    send_flip: torch.Tensor     # (NS, 1) orientation at those slots
    recv_slots: torch.Tensor    # (k,) replicated slots to overwrite
    recv_src: torch.Tensor      # (k,) their rows in the gathered buffer
    recv_flip: torch.Tensor     # (k, 1) receiver-side orientation

    def owned_duals(self, u_store: torch.Tensor) -> torch.Tensor:
        """The (NE, n) owned-slot rows of the u store (a view)."""
        lo = self.klo * self.block_edges
        return u_store[lo:lo + self.num_blocks * self.block_edges]

    def refresh_duals(self, u_store: torch.Tensor) -> torch.Tensor:
        """Overwrite the replicated dual slots of ``u_store`` in place
        with their owners' values and return it.  Owned rows are
        published in global orientation, all-gathered across the mesh
        axis and re-oriented into the local layout; owned and padding
        slots keep their values exactly."""
        with _scope(_prof.PHASE_HALO_GATHER):
            u_own = self.owned_duals(u_store)
            if self.comm == "boundary":
                buf = u_own[self.send_idx] * self.send_flip
            else:
                buf = u_own * self.orient
            gathered = self.mesh.all_gather(buf, self.axis)
            u_own[self.recv_slots] = gathered[self.recv_src] * self.recv_flip
            return u_store

    def write_back(self, w_store, u_store, w_new, u_new):
        """Store the fused step's outputs in the owned regions of the
        stores (the halo padding rows of ``w_store`` are inert zeros)."""
        w_store[:self.num_blocks * self.block_nodes].copy_(w_new)
        self.owned_duals(u_store).copy_(u_new)
        return w_store, u_store

    def residual(self, w_store, u_refreshed, w_new, u_new, tau, sigma):
        """Shard-local eq.-11 residual masked to *owned* rows.

        Owned rows see exactly the global update (halo closure), so the
        max of these over the shards is the global residual; halo rows
        are left out because their local primal state is not the global
        one."""
        f32 = torch.float32
        nv = self.num_blocks * self.block_nodes
        w_old = w_store[:nv]
        rp = torch.max(self.node_owned
                       * torch.abs(w_new.to(f32) - w_old.to(f32))
                       / tau[:nv].to(f32))
        u_old = self.owned_duals(u_refreshed)
        rd = torch.max(self.edge_owned
                       * torch.abs(u_new.to(f32) - u_old.to(f32))
                       / sigma.to(f32))
        return torch.maximum(rp, rd)


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

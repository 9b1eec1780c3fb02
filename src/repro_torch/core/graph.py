"""Empirical graph of local datasets (paper §2, Fig. 1), on PyTorch.

The counterpart of ``repro.core.graph``.  The graph keeps the same
gather-friendly layout:

  * edge endpoint arrays ``src``/``dst`` of shape (|E|,) with src < dst
    (the paper's block-incidence convention: D_{e,i} = +I for e={i,j},
    j>i, D_{e,j} = -I), and
  * a padded per-node incident-edge table ``inc_edges`` of shape
    (|V|, max_deg) with a matching sign table ``inc_signs`` (+1 / -1 / 0
    for padding), so that D^T u is a dense masked gather-sum.

The builders and the edge-blocked layout planner are the reference's
numpy code, copied verbatim so that both packages plan bit-identical
arrays from one seed; tensors are made only at the end, on the device
the caller names (``None`` = CUDA, see :mod:`repro_torch.device`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import weakref

import numpy as np
import torch

from repro_torch.device import resolve_device

# structure hashes are content hashes of frozen arrays, so they are
# computed once per graph *object* (EmpiricalGraph hashes by identity);
# the weak cache never retains graphs
_STRUCT_HASH_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeBlockLayout:
    """Edge-blocked graph layout for the fused primal-dual kernel.

    Planned on the host (``plan_edge_blocks``).  Nodes are RCM-reordered
    and grouped into ``num_blocks`` blocks of ``block_nodes``; edges are
    relabeled, canonicalized (src < dst in the *new* numbering —
    ``edge_flip`` records orientation changes so dual variables
    transform correctly), sorted by src, and assigned to the block owning
    their src endpoint.  Each block owns a contiguous, padded range of
    ``block_edges`` dual rows, and the layout guarantees:

      * every dst ("halo") endpoint of an edge owned by block b lies in
        the node window  [b*BV, b*BV + kn*BV),
      * every edge incident to an owned or halo node of block b lies in
        the edge window  [b*EB, b*EB + (klo+1+khi)*EB)  of the *shifted*
        edge storage (owned position + klo*EB).

    The TPU kernel streams those windows through VMEM; the CUDA kernel
    reads the same storage straight from device memory, so the window
    extents only size the padded stores there.

    Attributes (tensors on the graph's device; layout order unless
    noted):
      block_nodes/num_blocks/block_edges: BV, nb, EB above.
      kn, klo, khi:  halo window extents, in blocks.
      node_perm:     (nb*BV,) layout pos -> original node id (-1 padding).
      node_inv:      (V,) original node id -> layout pos.
      src, dst:      (nb*EB,) int32 endpoints in layout node ids (0 pads).
      weights:       (nb*EB,) float32 A_e (0.0 for padding slots).
      inc_edges:     (nb*BV, max_deg) int32 *storage* edge ids
                     (= owned position + klo*EB; 0-filled padding).
      inc_signs:     (nb*BV, max_deg) float32 +1/-1/0 as EmpiricalGraph.
      edge_pos:      (E,) original edge id -> owned layout position.
      edge_flip:     (E,) +1/-1; u_layout = edge_flip * u_original.
      in_ptr, in_ids, out_run:  the same incidence in the compact form the
                     CUDA kernel reads (:func:`compact_incidence`), built
                     on the host once, for the layout the planner keeps;
                     a field of the port only.
    """

    block_nodes: int
    num_blocks: int
    block_edges: int
    kn: int
    klo: int
    khi: int
    max_degree: int
    num_nodes: int
    num_edges: int
    node_perm: torch.Tensor
    node_inv: torch.Tensor
    src: torch.Tensor
    dst: torch.Tensor
    weights: torch.Tensor
    inc_edges: torch.Tensor
    inc_signs: torch.Tensor
    edge_pos: torch.Tensor
    edge_flip: torch.Tensor
    in_ptr: torch.Tensor | None = None
    in_ids: torch.Tensor | None = None
    out_run: torch.Tensor | None = None

    @property
    def compact(self) -> tuple:
        """``(in_ptr, in_ids, out_run)``: the compact incidence the fused
        kernel takes as ``incidence``."""
        return self.in_ptr, self.in_ids, self.out_run

    @property
    def nodes_pad(self) -> int:
        return self.num_blocks * self.block_nodes

    @property
    def edges_pad(self) -> int:
        return self.num_blocks * self.block_edges

    def pad_node_store(self, a: torch.Tensor) -> torch.Tensor:
        """Append the (kn-1)*BV halo-suffix zero rows to a
        (nodes_pad, ...) node-aligned tensor — the one store-shape
        convention shared by the fused setup and step paths."""
        ext = (self.kn - 1) * self.block_nodes
        pad = a.new_zeros((ext,) + tuple(a.shape[1:]))
        return torch.cat([a, pad], dim=0)

    def window_bytes(self, num_features: int,
                     param_floats: int | None = None,
                     itemsize: int = 4) -> int:
        """Footprint of one block's window, as the reference counts it.

        ``param_floats`` is the per-node float count of the loss's prox
        parameters (``Loss.prox_param_floats``); defaults to the squared
        loss's affine map (P, b).  ``itemsize`` is the *storage* dtype's
        byte width.  The block-size auto-tuner scores candidates with it,
        so it stays the reference's formula: the port picks the same
        rung.
        """
        n = num_features
        if param_floats is None:
            param_floats = n * n + n                          # P, b
        nw = self.kn * self.block_nodes
        ew = (self.klo + 1 + self.khi) * self.block_edges
        state = nw * (n + param_floats) + ew * n              # w, prox, u window
        state += self.block_edges * n                         # u+ (owned)
        index = nw * (1 + 2 * self.max_degree)                # tau, inc ids+signs
        index += self.block_edges * 4                         # src/dst/sig/la
        return itemsize * state + 4 * index


@dataclasses.dataclass(frozen=True, eq=False)
class EmpiricalGraph:
    """Undirected empirical graph with dense padded incidence structure.

    Attributes:
      src, dst:   (E,) int32, endpoints of each edge, src[e] < dst[e].
      weights:    (E,) float32, similarity weights A_e > 0.
      inc_edges:  (V, max_deg) int32, edge ids incident to each node
                  (padded with 0; validity given by inc_signs != 0).
      inc_signs:  (V, max_deg) float32, +1 if node is the src (j > i side),
                  -1 if dst, 0 for padding.  Matches D_{e,i} blocks.
      num_nodes:  int.
      layout:     optional :class:`EdgeBlockLayout` (attach with
                  :meth:`with_layout` to pre-plan the fused kernel's
                  edge-blocked layout once per graph).
    """

    src: torch.Tensor
    dst: torch.Tensor
    weights: torch.Tensor
    inc_edges: torch.Tensor
    inc_signs: torch.Tensor
    num_nodes: int
    layout: EdgeBlockLayout | None = None

    def with_layout(self, block_nodes: int | None = None) -> "EmpiricalGraph":
        """Attach a precomputed edge-blocked layout (host-side pass)."""
        return dataclasses.replace(
            self, layout=plan_edge_blocks(self, block_nodes=block_nodes))

    def to(self, device) -> "EmpiricalGraph":
        """The same graph with its tensors on ``device`` (layout dropped
        unless already there: it is re-planned on first use)."""
        dev = resolve_device(device)
        if self.src.device == dev:
            return self
        return EmpiricalGraph(
            src=self.src.to(dev), dst=self.dst.to(dev),
            weights=self.weights.to(dev), inc_edges=self.inc_edges.to(dev),
            inc_signs=self.inc_signs.to(dev), num_nodes=self.num_nodes)

    # -- basic properties ---------------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.src.device

    @property
    def num_edges(self) -> int:
        return self.src.shape[0]

    @property
    def max_degree(self) -> int:
        return self.inc_edges.shape[1]

    def degrees(self) -> torch.Tensor:
        """(V,) number of incident edges per node."""
        return torch.sum(self.inc_signs != 0.0, dim=1)

    def structure_hash(self) -> str:
        """Canonical content hash of the graph structure.

        Hashes (num_nodes, src, dst, weights) — everything a solve plan
        (RCM order, edge-blocked layout, stepsizes) depends on, and
        nothing the node-local data contributes.  Equal to the reference
        package's hash of the same graph.  Computed once per graph object
        and memoized in a weak cache.
        """
        cached = _STRUCT_HASH_CACHE.get(self)
        if cached is None:
            h = hashlib.blake2b(digest_size=16)
            h.update(np.int64(self.num_nodes).tobytes())
            h.update(self.src.cpu().numpy().astype(np.int64).tobytes())
            h.update(self.dst.cpu().numpy().astype(np.int64).tobytes())
            h.update(self.weights.cpu().numpy().astype(np.float32)
                     .tobytes())
            cached = h.hexdigest()
            _STRUCT_HASH_CACHE[self] = cached
        return cached

    # -- incidence operator D and its transpose -----------------------------
    def incidence_apply(self, w: torch.Tensor) -> torch.Tensor:
        """Apply block-incidence D: (V, n) node signal -> (E, n) edge signal.

        (D w)_e = w^(i) - w^(j) for e = {i, j}, i < j.
        """
        return w[self.src] - w[self.dst]

    def incidence_transpose_apply(self, u: torch.Tensor) -> torch.Tensor:
        """Apply D^T: (E, n) edge signal -> (V, n) node signal
        (dense masked gather-sum over the padded incidence table)."""
        gathered = u[self.inc_edges]                     # (V, max_deg, n)
        return torch.einsum("vd,vdn->vn", self.inc_signs, gathered)

    # -- TV seminorm (paper eq. 3) ------------------------------------------
    def total_variation(self, w: torch.Tensor) -> torch.Tensor:
        """||w||_TV = sum_e A_e ||w^(i) - w^(j)||_1."""
        diffs = self.incidence_apply(w)
        return torch.sum(self.weights * torch.sum(torch.abs(diffs), dim=1))

    # -- preconditioners (paper eq. 13) --------------------------------------
    def primal_stepsizes(self) -> torch.Tensor:
        """tau_i = 1 / |N_i|  (nodes with no edges get tau = 1)."""
        deg = self.degrees().to(torch.float32)
        return torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0),
                           torch.ones_like(deg))

    def dual_stepsizes(self) -> torch.Tensor:
        """sigma_e = 1/2 for all edges."""
        return torch.full((self.num_edges,), 0.5, dtype=torch.float32,
                          device=self.device)


def batched_incidence_apply(src: torch.Tensor, dst: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """D over lanes: (L, V, n) node signals -> (L, E, n) edge signals,
    with ``src`` / ``dst`` (E,) shared by every lane (a lambda path) or
    (L, E) per lane (a batch of graphs of one shape).  Lane l is
    :meth:`EmpiricalGraph.incidence_apply` of lane l's graph."""
    if src.ndim == 1:
        return w[:, src] - w[:, dst]
    lane = torch.arange(w.shape[0], device=w.device)[:, None]
    return w[lane, src] - w[lane, dst]


def batched_incidence_transpose_apply(inc_edges: torch.Tensor,
                                      inc_signs: torch.Tensor,
                                      u: torch.Tensor) -> torch.Tensor:
    """D^T over lanes: (L, E, n) edge signals -> (L, V, n) node signals,
    with the padded incidence tables (V, max_deg) shared by every lane or
    (L, V, max_deg) per lane.  Lane l is
    :meth:`EmpiricalGraph.incidence_transpose_apply` of lane l's graph."""
    if inc_edges.ndim == 2:
        gathered = u[:, inc_edges]                  # (L, V, max_deg, n)
        return torch.einsum("vd,lvdn->lvn", inc_signs, gathered)
    lane = torch.arange(u.shape[0], device=u.device)[:, None, None]
    gathered = u[lane, inc_edges]
    return torch.einsum("lvd,lvdn->lvn", inc_signs, gathered)


def build_graph(edges: np.ndarray, weights: np.ndarray, num_nodes: int,
                device=None) -> EmpiricalGraph:
    """Build an EmpiricalGraph from an (E, 2) integer edge list.

    Edges are canonicalized to src < dst, deduplicated, and sorted.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float32)
    if edges.size == 0:
        edges = np.zeros((0, 2), dtype=np.int64)
        weights = np.zeros((0,), dtype=np.float32)
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    if np.any(lo == hi):
        raise ValueError("self-loops are not allowed in the empirical graph")
    order = np.lexsort((hi, lo))
    lo, hi, weights = lo[order], hi[order], weights[order]
    # dedupe
    if len(lo):
        key = lo * num_nodes + hi
        keep = np.concatenate([[True], key[1:] != key[:-1]])
        lo, hi, weights = lo[keep], hi[keep], weights[keep]

    E = len(lo)
    deg = np.zeros(num_nodes, dtype=np.int64)
    np.add.at(deg, lo, 1)
    np.add.at(deg, hi, 1)
    max_deg = max(int(deg.max()) if num_nodes else 0, 1)

    # vectorized incidence scatter: interleave (src, dst) endpoints so each
    # node's slots keep edge order (src side +1 before dst side -1 for the
    # same edge), stable-sort by node, and the slot column is the rank
    # within the node's group — same fill order as a per-edge loop, O(E log E)
    inc_edges = np.zeros((num_nodes, max_deg), dtype=np.int32)
    inc_signs = np.zeros((num_nodes, max_deg), dtype=np.float32)
    if E:
        endpoints = np.empty(2 * E, dtype=np.int64)
        endpoints[0::2], endpoints[1::2] = lo, hi
        eid = np.repeat(np.arange(E, dtype=np.int64), 2)
        esign = np.tile(np.asarray([1.0, -1.0], np.float32), E)
        order2 = np.argsort(endpoints, kind="stable")
        nodes_sorted = endpoints[order2]
        group_start = np.concatenate([[0], np.cumsum(
            np.bincount(endpoints, minlength=num_nodes))])[:-1]
        slot = np.arange(2 * E) - group_start[nodes_sorted]
        inc_edges[nodes_sorted, slot] = eid[order2]
        inc_signs[nodes_sorted, slot] = esign[order2]

    return EmpiricalGraph(
        src=_tensor(lo, torch.int32, dev),
        dst=_tensor(hi, torch.int32, dev),
        weights=_tensor(weights, torch.float32, dev),
        inc_edges=_tensor(inc_edges, torch.int32, dev),
        inc_signs=_tensor(inc_signs, torch.float32, dev),
        num_nodes=int(num_nodes),
    )


def _tensor(a: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy -> tensor at ``dtype`` on ``device`` (one host copy)."""
    np_dtype = {torch.int32: np.int32, torch.float32: np.float32}[dtype]
    return torch.from_numpy(
        np.ascontiguousarray(a, dtype=np_dtype)).to(device)


def compact_incidence(inc_edges: np.ndarray, inc_signs: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The compact form of a layout's padded incidence tables.

    The planner fills each row with no holes: first the node's in-edges
    (sign -1, the edges whose dst it is), then its out-edges (sign +1)
    as one run of consecutive edge ids, since edges are sorted by src.
    So a row is a list of in-edge ids and one (first id, count) pair.
    Returns int32 arrays over the tables' rows:

      in_ptr  (rows + 1,): row r's in-edges are in_ids[in_ptr[r]:in_ptr[r+1]]
      in_ids  (in-slots,): in-edge ids, row after row, in slot order
      out_run (rows, 2):   (first id, count) of row r's out-edges

    Padding rows are empty (no in-edges, run (0, 0)).  Raises
    ValueError for tables not in that form.
    """
    e = np.asarray(inc_edges, np.int64)
    s = np.asarray(inc_signs)
    rows, width = s.shape
    col = np.arange(width)[None, :]
    n_in = np.count_nonzero(s < 0, axis=1)
    n_out = np.count_nonzero(s > 0, axis=1)
    is_in = col < n_in[:, None]
    is_out = (col >= n_in[:, None]) & (col < (n_in + n_out)[:, None])
    if not (np.array_equal(s < 0, is_in) and np.array_equal(s > 0, is_out)):
        raise ValueError("incidence rows must hold their -1 slots, then "
                         "their +1 slots, with no holes")
    first = np.where(n_out > 0, e[np.arange(rows),
                                  np.minimum(n_in, width - 1)], 0)
    run = first[:, None] + (col - n_in[:, None])
    if not np.array_equal(np.where(is_out, e, 0), np.where(is_out, run, 0)):
        raise ValueError("a row's +1 slots must be consecutive edge ids")
    in_ptr = np.concatenate([[0], np.cumsum(n_in)])
    return (in_ptr.astype(np.int32), e[is_in].astype(np.int32),
            np.stack([first, n_out], axis=1).astype(np.int32))


def _round_up(x: int, mult: int) -> int:
    return -(-max(x, 1) // mult) * mult


def _plan_edge_blocks_fixed(graph: EmpiricalGraph, block_nodes: int,
                            min_extents: dict | None = None, *,
                            compact: bool = True) -> EdgeBlockLayout:
    """Plan the edge-blocked layout for an explicit block size.

    ``min_extents`` forces lower bounds on the padded extents
    (``num_blocks`` / ``block_edges`` / ``kn`` / ``klo`` / ``khi`` /
    ``max_degree``).  Forced padding only widens windows and adds
    zero-weight slots — the planned incidence/ownership content is
    unchanged.  ``compact=False`` leaves out the compact incidence (the
    auto-tuner's candidates: :func:`with_compact` adds it to the one it
    keeps).
    """
    from repro_torch.core.partition import rcm_order_cached

    me = min_extents or {}
    V, E = graph.num_nodes, graph.num_edges
    src = graph.src.cpu().numpy().astype(np.int64)
    dst = graph.dst.cpu().numpy().astype(np.int64)
    wts = graph.weights.cpu().numpy().astype(np.float32)

    BV = int(block_nodes)
    nb = max(-(-max(V, 1) // BV), int(me.get("num_blocks", 1)))
    V_pad = nb * BV

    # 1. RCM relabel (bandwidth-minimizing => small halo windows); orders
    #    are memoized by structure hash
    order = (rcm_order_cached(graph) if E
             else np.arange(V, dtype=np.int64))
    inv = np.empty(V, dtype=np.int64)
    inv[order] = np.arange(V)
    node_perm = np.full(V_pad, -1, dtype=np.int64)
    node_perm[:V] = order

    # 2. relabel + canonicalize edges in the new numbering; a flipped
    #    orientation (src > dst after relabel) negates the dual variable
    s2, d2 = inv[src], inv[dst]
    flip = s2 > d2
    lo = np.minimum(s2, d2)
    hi = np.maximum(s2, d2)
    eorder = np.lexsort((hi, lo))          # sorted rank -> original edge id
    lo, hi = lo[eorder], hi[eorder]
    w2, flip2 = wts[eorder], flip[eorder]

    # 3. owner block = block of the (smaller) src endpoint; lo is sorted,
    #    so each block's owned edges are already contiguous — pad to EB
    owner = lo // BV if E else np.zeros(0, np.int64)
    counts = np.bincount(owner, minlength=nb)
    EB = max(_round_up(int(counts.max()) if E else 1, 8),
             int(me.get("block_edges", 1)))
    E_pad = nb * EB
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    pos = (owner * EB + (np.arange(E) - starts[owner])) if E else \
        np.zeros(0, np.int64)

    src_l = np.zeros(E_pad, dtype=np.int64)
    dst_l = np.zeros(E_pad, dtype=np.int64)
    w_l = np.zeros(E_pad, dtype=np.float32)
    src_l[pos], dst_l[pos], w_l[pos] = lo, hi, w2
    edge_pos = np.empty(E, dtype=np.int64)
    edge_pos[eorder] = pos
    edge_flip = np.where(flip, -1.0, 1.0).astype(np.float32)

    # 4. incidence tables over the padded layout nodes, in *owned* edge
    #    positions for now (shifted to storage ids once klo is known).
    max_deg = max(graph.max_degree, int(me.get("max_degree", 1)), 1)
    inc_e = np.zeros((V_pad, max_deg), dtype=np.int64)
    inc_s = np.zeros((V_pad, max_deg), dtype=np.float32)
    if E:
        endpoints = np.empty(2 * E, dtype=np.int64)
        endpoints[0::2], endpoints[1::2] = lo, hi
        epos = np.repeat(pos, 2)
        esign = np.tile(np.asarray([1.0, -1.0], np.float32), E)
        order2 = np.argsort(endpoints, kind="stable")
        nodes_sorted = endpoints[order2]
        deg_counts = np.bincount(endpoints, minlength=V_pad)
        group_start = np.concatenate([[0], np.cumsum(deg_counts)])[:-1]
        slot = np.arange(2 * E) - group_start[nodes_sorted]
        inc_e[nodes_sorted, slot] = epos[order2]
        inc_s[nodes_sorted, slot] = esign[order2]
    fill = np.count_nonzero(inc_s, axis=1)

    # 5. halo extents.  Per block b the step needs (a) w rows for owned
    #    nodes and dst endpoints of owned edges, (b) u rows for every edge
    #    incident to those nodes.
    has_inc = fill > 0
    node_emin = np.where(has_inc, np.where(inc_s != 0, inc_e,
                                           np.iinfo(np.int64).max).min(1), 0)
    node_emax = np.where(has_inc, np.where(inc_s != 0, inc_e, -1).max(1), 0)
    kn = int(me.get("kn", 1))
    klo = int(me.get("klo", 0))
    khi = int(me.get("khi", 0))
    for b in range(nb):
        own = slice(b * EB, b * EB + int(counts[b]))
        needed = np.arange(b * BV, min((b + 1) * BV, V_pad))
        if counts[b]:
            needed = np.unique(np.concatenate([needed, dst_l[own]]))
        needed = needed[has_inc[needed]]
        if len(needed):
            kn = max(kn, -(-(int(needed.max()) + 1 - b * BV) // BV))
            emin = int(node_emin[needed].min())
            emax = int(node_emax[needed].max())
            klo = max(klo, -(-(b * EB - emin) // EB))
            khi = max(khi, -(-(emax + 1 - (b + 1) * EB) // EB))
    klo, khi = max(klo, 0), max(khi, 0)

    inc_e = inc_e + klo * EB               # owned position -> storage id

    dev = graph.device
    lt = EdgeBlockLayout(
        block_nodes=BV, num_blocks=nb, block_edges=EB, kn=int(kn),
        klo=int(klo), khi=int(khi), max_degree=max_deg, num_nodes=V,
        num_edges=E,
        node_perm=_tensor(node_perm, torch.int32, dev),
        node_inv=_tensor(inv, torch.int32, dev),
        src=_tensor(src_l, torch.int32, dev),
        dst=_tensor(dst_l, torch.int32, dev),
        weights=_tensor(w_l, torch.float32, dev),
        inc_edges=_tensor(inc_e, torch.int32, dev),
        inc_signs=_tensor(inc_s, torch.float32, dev),
        edge_pos=_tensor(edge_pos, torch.int32, dev),
        edge_flip=_tensor(edge_flip, torch.float32, dev),
    )
    return with_compact(lt, inc_e, inc_s) if compact else lt


def with_compact(lt: EdgeBlockLayout, inc_edges: np.ndarray | None = None,
                 inc_signs: np.ndarray | None = None) -> EdgeBlockLayout:
    """``lt`` with its compact incidence, built on the host from its
    padded tables (``inc_edges`` / ``inc_signs`` as numpy arrays where
    the caller has them, else copied from the layout)."""
    if inc_edges is None:
        inc_edges = lt.inc_edges.cpu().numpy()
        inc_signs = lt.inc_signs.cpu().numpy()
    tables = compact_incidence(inc_edges, inc_signs)
    dev = lt.inc_edges.device
    return dataclasses.replace(lt, **{
        k: _tensor(a, torch.int32, dev)
        for k, a in zip(("in_ptr", "in_ids", "out_run"), tables)})


# candidate banded block sizes for the auto-tuner; whole-graph single
# block is always considered as the fallback candidate
_BLOCK_LADDER = (256, 512, 1024, 2048)


def plan_edge_blocks(graph: EmpiricalGraph,
                     block_nodes: int | None = None, *,
                     window_hint: tuple | None = None,
                     min_extents: dict | None = None) -> EdgeBlockLayout:
    """Host-side edge-blocked layout pass (see :class:`EdgeBlockLayout`).

    With ``block_nodes=None`` the block size is auto-tuned exactly as
    the reference does: candidate banded layouts (256 / 512 / 1024 /
    2048 nodes per block) are planned and scored by total window bytes
    per iteration (``num_blocks * window_bytes``).  ``window_hint =
    (num_features, param_floats, itemsize, max_window_bytes)`` makes the
    score dtype/loss-aware and rejects candidates over the window cap;
    when absent, a nominal (1, 0, 4, None) hint scores by row counts.
    When even the best banded candidate's halo extents exceed 3 blocks
    (RCM banding defeated), a single whole-graph block is used instead.
    """
    V = graph.num_nodes
    if block_nodes is not None:
        return _plan_edge_blocks_fixed(graph, int(block_nodes), min_extents)
    whole = _round_up(V, 8)
    if V <= 512:
        return _plan_edge_blocks_fixed(graph, whole, min_extents)

    nf, pf, isz, cap = window_hint if window_hint is not None \
        else (1, 0, 4, None)
    best = best_cost = None
    for bv in _BLOCK_LADDER:
        if bv >= whole:
            break
        lt = _plan_edge_blocks_fixed(graph, bv, min_extents, compact=False)
        wb = lt.window_bytes(nf, param_floats=pf, itemsize=isz)
        if cap is not None and wb > cap:
            continue
        cost = lt.num_blocks * wb
        if best is None or cost < best_cost:
            best, best_cost = lt, cost
    # quality guard: nb*kn*BV > 3*V_pad  <=>  kn > 3 (and likewise for the
    # edge window)
    if (best is None or best.kn > 3
            or (best.klo + 1 + best.khi) > 3):
        single = _plan_edge_blocks_fixed(graph, whole, min_extents,
                                         compact=False)
        swb = single.window_bytes(nf, param_floats=pf, itemsize=isz)
        if best is None or cap is None or swb <= cap:
            return with_compact(single)
    return with_compact(best)


def sbm_graph(rng: np.random.Generator, cluster_sizes, p_in: float,
              p_out: float, weight: float = 1.0, device=None
              ) -> tuple[EmpiricalGraph, np.ndarray]:
    """Stochastic block model empirical graph (paper §5).

    Returns (graph, cluster_assignment). Nodes within a cluster are
    connected with prob p_in, across clusters with prob p_out; all edge
    weights A_e are ``weight``.
    """
    sizes = list(cluster_sizes)
    num_nodes = int(sum(sizes))
    assign = np.concatenate([np.full(s, c) for c, s in enumerate(sizes)])
    iu, ju = np.triu_indices(num_nodes, k=1)
    same = assign[iu] == assign[ju]
    p = np.where(same, p_in, p_out)
    keep = rng.random(len(iu)) < p
    edges = np.stack([iu[keep], ju[keep]], axis=1)
    weights = np.full(edges.shape[0], weight, dtype=np.float32)
    g = build_graph(edges, weights, num_nodes, device=device)
    return g, assign


def sbm_graph_sparse(rng: np.random.Generator, cluster_sizes, p_in: float,
                     p_out: float, weight: float = 1.0, device=None
                     ) -> tuple[EmpiricalGraph, np.ndarray]:
    """O(E) stochastic block model sampler for million-node graphs.

    Per cluster pair, samples the Binomial(#pairs, p) edge *count* and
    then that many endpoint pairs uniformly at random.  Self-pairs are
    dropped and duplicate pairs collapse in ``build_graph``'s dedupe.
    Same return convention as :func:`sbm_graph`.
    """
    sizes = [int(s) for s in cluster_sizes]
    num_nodes = int(sum(sizes))
    assign = np.concatenate([np.full(s, c) for c, s in enumerate(sizes)])
    offs = np.concatenate([[0], np.cumsum(sizes)])
    chunks = []
    for a in range(len(sizes)):
        for b in range(a, len(sizes)):
            p = float(min(p_in if a == b else p_out, 1.0))
            pairs = (sizes[a] * (sizes[a] - 1)) // 2 if a == b \
                else sizes[a] * sizes[b]
            if p <= 0.0 or pairs == 0:
                continue
            k = int(rng.binomial(pairs, p))
            if not k:
                continue
            i = rng.integers(offs[a], offs[a + 1], size=k)
            j = rng.integers(offs[b], offs[b + 1], size=k)
            keep = i != j
            chunks.append(np.stack([i[keep], j[keep]], axis=1))
    edges = (np.concatenate(chunks, axis=0) if chunks
             else np.zeros((0, 2), np.int64))
    g = build_graph(edges, np.full(len(edges), weight, np.float32),
                    num_nodes, device=device)
    return g, assign


def chain_graph(rng: np.random.Generator, num_nodes: int,
                weight: float = 1.0, device=None) -> EmpiricalGraph:
    """Path graph 0-1-...-(V-1) — the fused-lasso / changepoint structure.

    Takes a ``numpy.random.Generator`` for the uniform generator
    signature; the family is deterministic.
    """
    del rng  # deterministic family; accepted for the uniform signature
    e = np.stack([np.arange(num_nodes - 1), np.arange(1, num_nodes)], axis=1)
    return build_graph(e, np.full(num_nodes - 1, weight, np.float32),
                       num_nodes, device=device)


def grid_graph(rng: np.random.Generator, rows: int, cols: int,
               weight: float = 1.0, device=None) -> EmpiricalGraph:
    """2-D lattice with 4-neighbour connectivity (image-denoising TV)."""
    del rng  # deterministic family; accepted for the uniform signature
    idx = np.arange(rows * cols).reshape(rows, cols)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    edges = np.concatenate([right, down], axis=0)
    return build_graph(edges, np.full(len(edges), weight, np.float32),
                       rows * cols, device=device)


def watts_strogatz_graph(rng: np.random.Generator, num_nodes: int,
                         k: int = 4, p_rewire: float = 0.1,
                         weight: float = 1.0, device=None) -> EmpiricalGraph:
    """Watts-Strogatz small world: ring lattice (k/2 neighbours per side)
    with each lattice edge rewired to a random endpoint with prob p_rewire.

    Rewiring keeps the source endpoint, never creates self-loops, and lets
    ``build_graph`` drop the (rare) duplicate edges.
    """
    if k % 2 or k <= 0:
        raise ValueError(f"k must be a positive even integer, got {k}")
    src, dst = [], []
    for hop in range(1, k // 2 + 1):
        i = np.arange(num_nodes)
        j = (i + hop) % num_nodes
        src.append(i)
        dst.append(j)
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    rewire = rng.random(len(src)) < p_rewire
    new_dst = rng.integers(0, num_nodes, size=len(src))
    # avoid self-loops on rewired edges (shift by one when they collide)
    new_dst = np.where(new_dst == src, (new_dst + 1) % num_nodes, new_dst)
    dst = np.where(rewire, new_dst, dst)
    edges = np.stack([src, dst], axis=1)
    return build_graph(edges, np.full(len(edges), weight, np.float32),
                       num_nodes, device=device)


def barabasi_albert_graph(rng: np.random.Generator, num_nodes: int,
                          m: int = 2, weight: float = 1.0,
                          device=None) -> EmpiricalGraph:
    """Barabasi-Albert preferential attachment: hub-dominated degrees.

    Starts from a complete seed graph on m+1 nodes; each arriving node
    attaches to m distinct existing nodes sampled proportionally to degree
    (sampling from the repeated-endpoints list).  The draws and the
    ``set`` iteration order are the reference's, so the edge list is too.
    """
    if not 1 <= m < num_nodes:
        raise ValueError(f"need 1 <= m < num_nodes, got m={m}, V={num_nodes}")
    seed_n = m + 1
    edges = [(i, j) for i in range(seed_n) for j in range(i + 1, seed_n)]
    # flat list of edge endpoints: sampling uniformly from it is sampling
    # nodes proportionally to degree
    endpoints = [v for e in edges for v in e]
    for v in range(seed_n, num_nodes):
        targets: set[int] = set()
        while len(targets) < m:
            targets.add(int(endpoints[rng.integers(0, len(endpoints))]))
        for t in targets:
            edges.append((t, v))
            endpoints.extend((t, v))
    edges = np.asarray(edges, dtype=np.int64)
    return build_graph(edges, np.full(len(edges), weight, np.float32),
                       num_nodes, device=device)


def ordered_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The sum of ``x`` over ``dim`` in one fixed order: a pairwise tree
    of elementwise adds (zero-padded to a power of two, halves added
    until one is left).  Each add is exactly rounded, so every row's sum
    is the same bits whatever the other dimensions hold: lane l of a
    lane-stacked evaluation equals a one-lane evaluation of its inputs,
    on any device (a library reduction picks its order from the shape,
    on the card from the number of rows)."""
    x = x.movedim(dim, -1)
    k = x.shape[-1]
    if k == 0:
        return x.new_zeros(x.shape[:-1])
    width = 1 << (k - 1).bit_length()
    if width != k:
        x = torch.nn.functional.pad(x, (0, width - k))
    while width > 1:
        width //= 2
        x = x[..., :width] + x[..., width:]
    return x[..., 0]


def lane_signal_mse(w_hat: torch.Tensor, w_true: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """:func:`graph_signal_mse` of every lane of ``w_hat`` (L, V, n)
    against ``w_true`` (V, n): (L,), summed in :func:`ordered_sum`'s
    order."""
    sq = ordered_sum((w_hat - w_true) ** 2, -1)
    return ordered_sum(torch.where(mask != 0, sq, torch.zeros_like(sq)),
                       -1) / w_hat.shape[-2]


def graph_signal_mse(w_hat: torch.Tensor, w_true: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Paper eq. (24): (1/|V|) sum_{i in mask} ||wbar_i - what_i||_2^2."""
    sq = torch.sum((w_hat - w_true) ** 2, dim=1)
    return torch.sum(torch.where(mask != 0, sq,
                                 torch.zeros_like(sq))) / w_hat.shape[0]

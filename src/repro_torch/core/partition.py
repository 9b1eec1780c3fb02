"""Graph partitioning and node orderings, on the host.

The port keeps its own copy of the host-side numpy planners of
``repro.core.partition``, so a plan made here is bit-identical to the
reference's on the same graph:

  * the shard partitioners of the sharded backends — ``block_partition``
    (contiguous blocks) and ``cluster_partition`` (gain-based greedy
    region growing, so that most edges stay inside a shard) — and
    :func:`plan_partition`, whose :class:`PartitionPlan` makes every
    shard a contiguous, padded slice of nodes and of edges (each edge
    owned by the shard of its ``src`` endpoint);
  * :func:`plan_hierarchy`, the two-level layout of ``sharded_fused``
    (:class:`HierarchyPlan`: cluster cuts between shards, an RCM +
    edge-blocked layout within each);
  * the reverse Cuthill-McKee order, its structure-hash cache with the
    export/install pair that plan persistence uses, and the serving
    layer's dual transfer across edge patches.

The ``permute_*`` / ``unpermute_*`` helpers move (V, ...) / (E, ...)
arrays into a :class:`PartitionPlan`'s layout and back, in numpy and, as
``*_device``, as tensor gathers on the array's device
(:func:`gather_padded`).
"""
from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch.device import to_host


@dataclasses.dataclass(frozen=True)
class PartitionPlan:
    num_shards: int
    nodes_per_shard: int          # padded
    edges_per_shard: int          # padded
    node_perm: np.ndarray         # (V_pad,) new position -> old node id (-1 pad)
    node_inv: np.ndarray          # (V,) old node id -> new position
    edge_perm: np.ndarray         # (E_pad,) new position -> old edge id (-1 pad)
    edge_inv: np.ndarray          # (E,) old edge id -> new position
    src_new: np.ndarray           # (E_pad,) src in new node numbering
    dst_new: np.ndarray           # (E_pad,) dst in new node numbering
    weights: np.ndarray           # (E_pad,) 0.0 for padding
    cut_edges: int                # edges crossing shards
    boundary_nodes: int           # nodes incident to a cut edge


def block_partition(num_nodes: int, num_shards: int) -> np.ndarray:
    """(V,) shard assignment by contiguous blocks."""
    per = -(-num_nodes // num_shards)
    return np.minimum(np.arange(num_nodes) // per, num_shards - 1)


def cluster_partition(graph, num_shards: int, seed: int = 0) -> np.ndarray:
    """Gain-based greedy region growing (GGGP-style): grow P regions of
    ~equal size, always absorbing the frontier node with the most
    neighbours already inside the current region.

    The gain priority is what makes this *cluster-aware*: a candidate
    reached through a single cross-cluster edge (gain 1) always loses to
    the in-cluster frontier (gain ~ average degree), so a region swallows
    whole clusters before spilling across a cut.  On clustered graphs
    (SBM) it keeps most edges internal, which is what the
    boundary-exchange solver and the hierarchical halo exchange exploit.
    The reference's numpy and ``heapq`` calls in the reference's order:
    the same seed gives the same assignment.
    """
    V = graph.num_nodes
    src = to_host(graph.src).astype(np.int64)
    dst = to_host(graph.dst).astype(np.int64)
    E = len(src)
    # CSR adjacency (src entry before dst entry per edge; the interleave
    # + stable sort is O(E log E) instead of interpreter-bound appends)
    ends = np.empty(2 * E, dtype=np.int64)
    nbrs = np.empty(2 * E, dtype=np.int64)
    ends[0::2], ends[1::2] = src, dst
    nbrs[0::2], nbrs[1::2] = dst, src
    csr = np.argsort(ends, kind="stable")
    nbrs = nbrs[csr]
    indptr = np.concatenate([[0], np.cumsum(
        np.bincount(ends, minlength=V))]).astype(np.int64)
    target = -(-V // num_shards)
    rng = np.random.default_rng(seed)
    order = rng.permutation(V).tolist()
    # the walk's per-node state as Python lists: the loop reads and
    # writes single entries, which numpy scalar indexing makes ~3x slower
    starts = indptr.tolist()
    assign = [-1] * V
    gain = [0] * V
    epoch = [-1] * V                   # last region that touched a node
    shard = 0
    count = 0
    ptr = 0
    # lazy max-heap of (-gain, node): stale (lower-gain) entries pop
    # after the fresh ones and are skipped once the node is assigned
    heap: list[tuple[int, int]] = []
    while shard < num_shards:
        if not heap:
            while ptr < V and assign[order[ptr]] >= 0:
                ptr += 1
            if ptr >= V:
                break
            heap.append((0, order[ptr]))
        _, node = heapq.heappop(heap)
        if assign[node] >= 0:
            continue
        assign[node] = shard
        count += 1
        if count >= target:
            shard += 1
            count = 0
            heap.clear()
            continue
        # no assignment changes while a node's neighbours are pushed, so
        # testing each in turn skips the ones assigned before the node
        for nb in nbrs[starts[node]:starts[node + 1]].tolist():
            if assign[nb] >= 0:
                continue
            if epoch[nb] != shard:
                epoch[nb] = shard
                gain[nb] = 0
            gain[nb] += 1
            heapq.heappush(heap, (-gain[nb], nb))
    out = np.asarray(assign, dtype=np.int64)
    out[out < 0] = num_shards - 1
    return out


def plan_partition(graph, assign: np.ndarray,
                   num_shards: int) -> PartitionPlan:
    """Build permutation + padding so each shard is a contiguous slice."""
    V = graph.num_nodes
    E = graph.num_edges
    src = to_host(graph.src)
    dst = to_host(graph.dst)
    weights = to_host(graph.weights)

    order = np.argsort(assign, kind="stable")              # nodes by shard
    counts = np.bincount(assign, minlength=num_shards)
    vp = int(counts.max()) if V else 1
    node_perm = np.full(num_shards * vp, -1, dtype=np.int64)
    node_inv = np.empty(V, dtype=np.int64)
    pos = 0
    for s in range(num_shards):
        ids = order[pos:pos + counts[s]]
        node_perm[s * vp:s * vp + len(ids)] = ids
        node_inv[ids] = s * vp + np.arange(len(ids))
        pos += counts[s]

    # edges owned by the shard of src
    e_shard = assign[src]
    e_order = np.argsort(e_shard, kind="stable")
    e_counts = np.bincount(e_shard, minlength=num_shards)
    ep = max(int(e_counts.max()) if E else 1, 1)
    edge_perm = np.full(num_shards * ep, -1, dtype=np.int64)
    edge_inv = np.empty(E, dtype=np.int64)
    pos = 0
    for s in range(num_shards):
        ids = e_order[pos:pos + e_counts[s]]
        edge_perm[s * ep:s * ep + len(ids)] = ids
        edge_inv[ids] = s * ep + np.arange(len(ids))
        pos += e_counts[s]

    valid = edge_perm >= 0
    src_new = np.zeros(len(edge_perm), dtype=np.int64)
    dst_new = np.zeros(len(edge_perm), dtype=np.int64)
    w_new = np.zeros(len(edge_perm), dtype=np.float32)
    src_new[valid] = node_inv[src[edge_perm[valid]]]
    dst_new[valid] = node_inv[dst[edge_perm[valid]]]
    w_new[valid] = weights[edge_perm[valid]]

    cut = int(np.sum(assign[src] != assign[dst]))
    bnodes = np.unique(np.concatenate([
        src[assign[src] != assign[dst]], dst[assign[src] != assign[dst]]]))
    return PartitionPlan(
        num_shards=num_shards, nodes_per_shard=vp, edges_per_shard=ep,
        node_perm=node_perm, node_inv=node_inv, edge_perm=edge_perm,
        edge_inv=edge_inv, src_new=src_new, dst_new=dst_new, weights=w_new,
        cut_edges=cut, boundary_nodes=len(bnodes))


def rcm_order(src: np.ndarray, dst: np.ndarray, num_nodes: int,
              reverse: bool = True) -> np.ndarray:
    """(Reverse) Cuthill-McKee node ordering: new position -> old node id.

    BFS from a minimum-degree node per component, visiting neighbours in
    increasing-degree order; the reversal minimizes profile/bandwidth of
    the reordered adjacency.  A banded ordering is what makes the
    edge-blocked layout's halo windows small (graph.plan_edge_blocks):
    after relabeling, every edge connects nearby node ids, so the edges
    incident to a contiguous node block occupy a short contiguous range.
    """
    V = num_nodes
    E = len(src)
    deg = np.zeros(V, dtype=np.int64)
    np.add.at(deg, src, 1)
    np.add.at(deg, dst, 1)
    # CSR adjacency with neighbour lists sorted by (degree, id): one
    # global lexsort instead of per-node python list sorts
    ends = np.concatenate([src, dst])
    nbrs = np.concatenate([dst, src])
    csr_order = np.lexsort((nbrs, deg[nbrs], ends))
    nbrs = nbrs[csr_order]
    indptr = np.concatenate([[0], np.cumsum(np.bincount(
        ends, minlength=V))]) if E else np.zeros(V + 1, np.int64)

    visited = np.zeros(V, dtype=bool)
    order = np.empty(V, dtype=np.int64)
    pos = 0
    # component seeds in min-degree order (isolated nodes come first,
    # which conveniently packs them into the same blocks)
    seeds = np.argsort(deg, kind="stable")
    queue: deque[int] = deque()
    for seed in seeds:
        if visited[seed]:
            continue
        visited[seed] = True
        queue.append(int(seed))
        while queue:
            v = queue.popleft()
            order[pos] = v
            pos += 1
            ns = nbrs[indptr[v]:indptr[v + 1]]
            ns = ns[~visited[ns]]
            visited[ns] = True
            queue.extend(ns.tolist())
    assert pos == V
    return order[::-1].copy() if reverse else order


# RCM orders keyed by graph structure hash: re-planning an isomorphic
# graph (e.g. a graph whose data changed but whose edges did not) reuses
# the BFS result.  Bounded LRU so long-lived processes with many distinct
# structures don't grow without limit.
_RCM_CACHE: "OrderedDict[tuple[str, bool], np.ndarray]" = OrderedDict()
_RCM_CACHE_MAX = 128


def rcm_order_cached(graph, reverse: bool = True) -> np.ndarray:
    """:func:`rcm_order` memoized by ``graph.structure_hash()``."""
    key = (graph.structure_hash(), reverse)
    order = _RCM_CACHE.get(key)
    if order is None:
        order = rcm_order(graph.src.cpu().numpy().astype(np.int64),
                          graph.dst.cpu().numpy().astype(np.int64),
                          graph.num_nodes, reverse=reverse)
        order.setflags(write=False)
        _RCM_CACHE[key] = order
        while len(_RCM_CACHE) > _RCM_CACHE_MAX:
            _RCM_CACHE.popitem(last=False)
    else:
        _RCM_CACHE.move_to_end(key)
    return order


def export_rcm_orders(
        structure_hashes: "set[str] | None" = None,
) -> "dict[tuple[str, bool], np.ndarray]":
    """Snapshot the memoized RCM orders, optionally filtered by hash.

    Plan persistence (``serving.PlanCache.save``) exports the orders
    behind its cached layouts so a restarted process skips the BFS too.
    """
    return {key: order for key, order in _RCM_CACHE.items()
            if structure_hashes is None or key[0] in structure_hashes}


def install_rcm_order(structure_hash: str, order: np.ndarray,
                      reverse: bool = True) -> None:
    """Seed the RCM memo with a deserialized order (restore path)."""
    order = np.asarray(order, np.int64).copy()
    order.setflags(write=False)
    key = (structure_hash, bool(reverse))
    _RCM_CACHE[key] = order
    _RCM_CACHE.move_to_end(key)
    while len(_RCM_CACHE) > _RCM_CACHE_MAX:
        _RCM_CACHE.popitem(last=False)


def transfer_edge_duals(old_graph, new_graph, u_old) -> np.ndarray:
    """Map an (E_old, n) dual vector onto a patched graph's edge set.

    The warm-start story for edge add/drop patches: edges are matched by
    their *unordered* endpoint pair, surviving any relabeling the patch
    caused.  A matched edge whose stored orientation differs between the
    two graphs (src/dst swapped) has its dual row negated — u_e lives on
    the oriented difference w_src - w_dst, so flipping the orientation
    flips the sign.  Unmatched (added) edges start from the zero dual,
    exactly the cold initialization; dropped edges' rows vanish.

    Host-side (numpy): edge patches are host events in the serving
    layer.  Returns an (E_new, n) float32 array, bit-equal to the
    reference's on the same graphs.
    """
    u_old = to_host(u_old).astype(np.float32)
    o_src = to_host(old_graph.src).astype(np.int64)
    o_dst = to_host(old_graph.dst).astype(np.int64)
    n_src = to_host(new_graph.src).astype(np.int64)
    n_dst = to_host(new_graph.dst).astype(np.int64)
    u_new = np.zeros((len(n_src),) + u_old.shape[1:], np.float32)
    if not len(o_src) or not len(n_src):
        return u_new

    base = np.int64(max(old_graph.num_nodes, new_graph.num_nodes))
    key_o = np.minimum(o_src, o_dst) * base + np.maximum(o_src, o_dst)
    key_n = np.minimum(n_src, n_dst) * base + np.maximum(n_src, n_dst)
    # orientation relative to canonical (src < dst): +1 canonical, -1
    # flipped.  relative flip old -> new = product of the two.
    sign_o = np.where(o_src < o_dst, 1.0, -1.0).astype(np.float32)
    sign_n = np.where(n_src < n_dst, 1.0, -1.0).astype(np.float32)

    sorter = np.argsort(key_o, kind="stable")
    idx = np.searchsorted(key_o, key_n, sorter=sorter)
    idx_c = np.minimum(idx, len(key_o) - 1)
    found = key_o[sorter[idx_c]] == key_n
    match = sorter[idx_c[found]]
    sign = (sign_o[match] * sign_n[found]).reshape(
        (-1,) + (1,) * (u_old.ndim - 1))
    u_new[found] = u_old[match] * sign
    return u_new


def gather_padded(arr: torch.Tensor, perm: torch.Tensor,
                  fill: float = 0.0) -> torch.Tensor:
    """Gather rows of ``arr`` by a -1-padded permutation.

    ``perm`` maps output row -> input row, with -1 marking padding rows
    that receive ``fill``.  The single implementation behind every padded
    permute of the edge-blocked layout.
    """
    perm = perm.to(device=arr.device, dtype=torch.long)
    out = arr[perm.clamp(0, max(arr.shape[0] - 1, 0))]
    valid = (perm >= 0).reshape((-1,) + (1,) * (arr.ndim - 1))
    # torch.full, not torch.tensor: no host-to-device copy, so a solve's
    # set-up never synchronizes the card
    return torch.where(valid, out, torch.full((), fill, dtype=arr.dtype,
                                              device=arr.device))


# ---------------------------------------------------------------------------
# Two-level (hierarchical) layout: cluster cuts between shards, RCM +
# edge blocks within each shard.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HierarchyPlan:
    """Two-level layout for the ``sharded_fused`` backend.

    Level 1 (between shards): a cluster-aware node partition; each shard
    owns its nodes and the edges whose ``src`` endpoint it owns.  Level 2
    (within a shard): an RCM + edge-blocked :class:`EdgeBlockLayout`
    planned over the shard's *local subgraph* — the owned nodes, their
    1-hop halo closure, and every edge incident to that closure.  The
    halo closure makes each shard's fused kernel step exact on owned
    nodes and owned edges given only a per-iteration refresh of the
    duals of replicated (non-owned) local edges: halo-node primal
    updates are recomputed redundantly instead of communicated, and the
    locally-computed duals of replicated edges are overwritten at the
    next refresh, so second-ring staleness never reaches owned state.

    All shards share one static extent signature (``block_nodes`` /
    ``num_blocks`` / ``block_edges`` / ``kn`` / ``klo`` / ``khi`` /
    ``max_degree``): the per-shard layouts are re-planned with the
    across-shard maxima forced, so one kernel launch shape serves every
    shard.  Stacked per-shard arrays have leading dimension ``S * rows``
    and shard s occupies rows ``[s*rows, (s+1)*rows)``.

    Orientation convention: every per-shard layout stores the dual of
    edge e as ``u_layout = orient * u_global`` with ``orient`` in
    {+1, -1} (local subgraphs preserve the global canonical src < dst
    orientation, so ``orient`` is exactly the local layout's
    ``edge_flip``); exchange buffers travel in *global* orientation.
    """

    num_shards: int
    num_nodes: int
    num_edges: int
    # common static layout extents
    block_nodes: int
    num_blocks: int
    block_edges: int
    kn: int
    klo: int
    khi: int
    max_degree: int
    # per-shard stacked arrays (host numpy)
    node_map: np.ndarray        # (S*NV,) layout row -> global node id (-1 pad)
    node_owned: np.ndarray      # (S*NV,) f32 1.0 where assign[node] == shard
    inc_edges: np.ndarray       # (S*NV, max_degree) int32 storage edge ids
    inc_signs: np.ndarray       # (S*NV, max_degree) f32 +1/-1/0
    src: np.ndarray             # (S*NE,) int32 layout node ids per owned slot
    dst: np.ndarray             # (S*NE,) int32
    weights: np.ndarray         # (S*NE,) f32 A_e (0 for padding slots)
    edge_map: np.ndarray        # (S*NE,) owned slot -> global edge id (-1 pad)
    edge_owned: np.ndarray      # (S*NE,) f32 1.0 where this shard owns the edge
    orient: np.ndarray          # (S*NE,) f32 +-1 (0 pad): u_layout=orient*u_glob
    # dual-refresh exchange tables
    send_rows: int              # NS: compacted send-buffer rows per shard
    send_idx: np.ndarray        # (S*NS,) int32 owned slot to send (0 pad)
    send_flip: np.ndarray       # (S*NS,) f32 orient at that slot (0 pad)
    recv_src: np.ndarray        # (S*NE,) int32 row in gathered compact buffer
    recv_src_dense: np.ndarray  # (S*NE,) int32 row in gathered full slab
    recv_flip: np.ndarray       # (S*NE,) f32 sign for gathered rows (0 if owned)
    # global <-> stacked-store gathers
    w_sel: np.ndarray           # (V,) flat row of the owning shard's w store
    u_sel: np.ndarray           # (E,) flat row of the owning shard's u store
    u_flip: np.ndarray          # (E,) f32 +-1 layout -> global orientation
    w_inj: np.ndarray           # (S*WSR,) global node id or -1 (zero-fill)
    u_inj: np.ndarray           # (S*ESR,) global edge id or -1
    u_inj_flip: np.ndarray      # (S*ESR,) f32 orient (0 pad)
    # statistics (roofline + halo-traffic metering)
    cut_edges: int
    cut_fraction: float
    halo_nodes: int
    replicated_edges: int

    @property
    def nodes_pad(self) -> int:
        """NV: layout node rows per shard."""
        return self.num_blocks * self.block_nodes

    @property
    def edges_pad(self) -> int:
        """NE: owned edge slots per shard."""
        return self.num_blocks * self.block_edges

    @property
    def w_store_rows(self) -> int:
        """Per-shard w store rows (layout nodes + halo suffix padding)."""
        return (self.num_blocks + self.kn - 1) * self.block_nodes

    @property
    def u_store_rows(self) -> int:
        """Per-shard u store rows (klo/khi halo + owned region)."""
        return (self.num_blocks + self.klo + self.khi) * self.block_edges

    def exchange_rows(self, comm: str) -> int:
        """Per-shard all-gather payload rows per iteration."""
        return self.send_rows if comm == "boundary" else self.edges_pad


def _expand_csr(ids: np.ndarray, starts: np.ndarray, counts: np.ndarray,
                values: np.ndarray, tags: np.ndarray):
    """Gather ``values[starts[v] : starts[v]+counts[v]]`` for each v in
    ``ids``, repeating ``tags`` alongside — the vectorized flatten of a
    ragged per-node lookup."""
    c = counts[ids]
    total = int(c.sum())
    cum = np.concatenate([[0], np.cumsum(c)])[:-1]
    pos = (np.arange(total) - np.repeat(cum, c)
           + np.repeat(starts[ids], c))
    return values[pos], np.repeat(tags, c)


def plan_hierarchy(graph, assign: np.ndarray, num_shards: int, *,
                   window_hint: tuple | None = None) -> HierarchyPlan:
    """Build the two-level layout for a node-to-shard assignment.

    ``window_hint`` is forwarded to the within-shard
    :func:`repro_torch.core.graph.plan_edge_blocks` auto-tuner (the block
    size is chosen once, on the largest local subgraph, then forced on
    every shard together with the across-shard maxima of all padded
    extents).  The local subgraphs are planned on the CPU whatever the
    graph's device: the plan is host numpy.
    """
    from repro_torch.core.graph import (_plan_edge_blocks_fixed,
                                        build_graph, plan_edge_blocks)

    V, E = graph.num_nodes, graph.num_edges
    src = to_host(graph.src).astype(np.int64)
    dst = to_host(graph.dst).astype(np.int64)
    wts = to_host(graph.weights).astype(np.float32)
    assign = np.asarray(assign, np.int64)
    S = int(num_shards)
    if len(assign) != V or (V and (assign.min() < 0 or assign.max() >= S)):
        raise ValueError("assign must map every node to [0, num_shards)")
    owner_e = assign[src] if E else np.zeros(0, np.int64)

    # --- level 1: 1-hop halo closure membership -------------------------
    # node v belongs to N1(s) for its own shard and for every foreign
    # shard among its neighbours; edge e belongs to F_s iff one of its
    # endpoints is in N1(s).  Both as deduped (id, shard) pair sets.
    cut = (assign[src] != assign[dst]) if E else np.zeros(0, bool)
    mem_nodes = np.concatenate([np.arange(V), src[cut], dst[cut]])
    mem_shards = np.concatenate([assign, assign[dst[cut]],
                                 assign[src[cut]]])
    mem = np.unique(mem_nodes * S + mem_shards)
    m_node, m_shard = mem // S, mem % S
    m_counts = np.bincount(m_node, minlength=V)
    m_starts = np.concatenate([[0], np.cumsum(m_counts)])[:-1]

    if E:
        eids = np.arange(E, dtype=np.int64)
        sh_a, e_a = _expand_csr(src, m_starts, m_counts, m_shard, eids)
        sh_b, e_b = _expand_csr(dst, m_starts, m_counts, m_shard, eids)
        e_pairs = np.unique(np.concatenate([e_a, e_b]) * S
                            + np.concatenate([sh_a, sh_b]))
        f_edge, f_shard = e_pairs // S, e_pairs % S
    else:
        f_edge = f_shard = np.zeros(0, np.int64)

    # --- level 2: per-shard local subgraphs + common-extent layouts -----
    locals_ = []
    for s in range(S):
        gids_e = f_edge[f_shard == s]          # ascending global edge ids
        gn = np.unique(np.concatenate(
            [np.flatnonzero(assign == s), src[gids_e], dst[gids_e]]))
        # local ids are the rank within gn: strictly monotone in global
        # ids, so the global canonical (src < dst, lexsorted) edge order
        # is preserved and local edge i corresponds to gids_e[i] with no
        # orientation flip
        lsrc = np.searchsorted(gn, src[gids_e])
        ldst = np.searchsorted(gn, dst[gids_e])
        lg = build_graph(np.stack([lsrc, ldst], axis=1), wts[gids_e],
                         len(gn), device="cpu")
        if lg.num_edges != len(gids_e):
            raise AssertionError("local subgraph lost edges")
        locals_.append((gids_e, gn, lg))

    ref = int(np.argmax([len(gn) for _, gn, _ in locals_])) if S else 0
    lt_ref = plan_edge_blocks(locals_[ref][2], window_hint=window_hint)
    BV = lt_ref.block_nodes
    # every shard planned at BV (the reference's plan_edge_blocks with
    # block_nodes=BV).  The auto-tuner planned its pick at BV with no
    # forced extents already, the same arrays, so the largest shard's
    # plan is reused; the compact incidence is built per shard later,
    # from the stacked tables, so the others leave it out
    pass2 = [lt_ref if i == ref
             else _plan_edge_blocks_fixed(lg, BV, compact=False)
             for i, (_, _, lg) in enumerate(locals_)]
    me = {
        "num_blocks": max(lt.num_blocks for lt in pass2),
        "block_edges": max(lt.block_edges for lt in pass2),
        "kn": max(lt.kn for lt in pass2),
        "klo": max(lt.klo for lt in pass2),
        "khi": max(lt.khi for lt in pass2),
        "max_degree": max(lt.max_degree for lt in pass2),
    }
    layouts = [lt if (lt.num_blocks, lt.block_edges, lt.kn, lt.klo,
                      lt.khi, lt.max_degree) == tuple(me.values())
               else _plan_edge_blocks_fixed(lg, BV, me, compact=False)
               for lt, (_, _, lg) in zip(pass2, locals_)]

    nb, EB = me["num_blocks"], me["block_edges"]
    kn, klo, khi, md = me["kn"], me["klo"], me["khi"], me["max_degree"]
    NV, NE = nb * BV, nb * EB
    WSR = (nb + kn - 1) * BV
    ESR = (nb + klo + khi) * EB

    node_map = np.full(S * NV, -1, np.int64)
    node_owned = np.zeros(S * NV, np.float32)
    inc_e = np.zeros((S * NV, md), np.int32)
    inc_s = np.zeros((S * NV, md), np.float32)
    src_l = np.zeros(S * NE, np.int32)
    dst_l = np.zeros(S * NE, np.int32)
    w_l = np.zeros(S * NE, np.float32)
    edge_map = np.full(S * NE, -1, np.int64)
    edge_owned = np.zeros(S * NE, np.float32)
    orient = np.zeros(S * NE, np.float32)
    own_pos = np.full(E, -1, np.int64)     # global edge -> owner's slot

    for s, ((gids_e, gn, _), lt) in enumerate(zip(locals_, layouts)):
        nperm = to_host(lt.node_perm).astype(np.int64)
        valid = nperm >= 0
        nm = np.full(NV, -1, np.int64)
        nm[valid] = gn[nperm[valid]]
        node_map[s * NV:(s + 1) * NV] = nm
        node_owned[s * NV:(s + 1) * NV] = np.where(
            valid & (assign[np.clip(nm, 0, max(V - 1, 0))] == s)
            if V else valid, 1.0, 0.0)
        inc_e[s * NV:(s + 1) * NV] = to_host(lt.inc_edges)
        inc_s[s * NV:(s + 1) * NV] = to_host(lt.inc_signs)
        src_l[s * NE:(s + 1) * NE] = to_host(lt.src)
        dst_l[s * NE:(s + 1) * NE] = to_host(lt.dst)
        w_l[s * NE:(s + 1) * NE] = to_host(lt.weights)
        pos = to_host(lt.edge_pos).astype(np.int64)
        flip = to_host(lt.edge_flip).astype(np.float32)
        em = np.full(NE, -1, np.int64)
        em[pos] = gids_e
        edge_map[s * NE:(s + 1) * NE] = em
        orr = np.zeros(NE, np.float32)
        orr[pos] = flip
        orient[s * NE:(s + 1) * NE] = orr
        owned = owner_e[gids_e] == s
        eo = np.zeros(NE, np.float32)
        eo[pos[owned]] = 1.0
        edge_owned[s * NE:(s + 1) * NE] = eo
        own_pos[gids_e[owned]] = pos[owned]
    if E and (own_pos < 0).any():
        raise AssertionError("edge owner missing from its own halo closure")

    # --- dual-refresh exchange tables -----------------------------------
    # receiver needs: valid, non-owned slots
    flat = np.arange(S * NE)
    need = (edge_map >= 0) & (edge_owned == 0.0)
    need_gid = edge_map[need]
    need_owner = owner_e[need_gid]
    # compacted per-owner send lists (sorted by gid for searchsorted)
    pair = np.unique(need_owner * max(E, 1) + need_gid) if len(need_gid) \
        else np.zeros(0, np.int64)
    p_owner, p_gid = pair // max(E, 1), pair % max(E, 1)
    s_counts = np.bincount(p_owner, minlength=S) if S else np.zeros(0)
    NS = max(int(s_counts.max()) if len(pair) else 0, 1)
    s_starts = np.concatenate([[0], np.cumsum(s_counts)])[:-1]
    send_idx = np.zeros(S * NS, np.int32)
    send_flip = np.zeros(S * NS, np.float32)
    rank = np.arange(len(pair)) - s_starts[p_owner] if len(pair) else pair
    send_slot = p_owner * NS + rank
    send_idx[send_slot] = own_pos[p_gid]
    send_flip[send_slot] = orient[p_owner * NE + own_pos[p_gid]]

    recv_src = np.zeros(S * NE, np.int32)
    recv_src_dense = np.zeros(S * NE, np.int32)
    recv_flip = np.zeros(S * NE, np.float32)
    if len(need_gid):
        # rank of each needed gid inside its owner's sorted send list
        k = (np.searchsorted(pair, need_owner * max(E, 1) + need_gid)
             - s_starts[need_owner])
        recv_src[flat[need]] = need_owner * NS + k
        recv_src_dense[flat[need]] = need_owner * NE + own_pos[need_gid]
        recv_flip[flat[need]] = orient[flat[need]]

    # --- global <-> stacked-store gathers -------------------------------
    w_sel = np.zeros(V, np.int64)
    u_sel = np.zeros(E, np.int64)
    u_flip = np.ones(E, np.float32)
    w_inj = np.full(S * WSR, -1, np.int64)
    u_inj = np.full(S * ESR, -1, np.int64)
    u_inj_flip = np.zeros(S * ESR, np.float32)
    for s in range(S):
        nm = node_map[s * NV:(s + 1) * NV]
        own_n = node_owned[s * NV:(s + 1) * NV] > 0
        w_sel[nm[own_n]] = s * WSR + np.flatnonzero(own_n)
        em = edge_map[s * NE:(s + 1) * NE]
        own_e = edge_owned[s * NE:(s + 1) * NE] > 0
        u_sel[em[own_e]] = s * ESR + klo * EB + np.flatnonzero(own_e)
        u_flip[em[own_e]] = orient[s * NE:(s + 1) * NE][own_e]
        w_inj[s * WSR:s * WSR + NV] = nm
        u_inj[s * ESR + klo * EB:s * ESR + klo * EB + NE] = em
        u_inj_flip[s * ESR + klo * EB:s * ESR + klo * EB + NE] = \
            orient[s * NE:(s + 1) * NE]

    halo = int(np.sum((node_map >= 0) & (node_owned == 0.0)))
    replicated = int(np.sum(edge_map >= 0)) - E
    return HierarchyPlan(
        num_shards=S, num_nodes=V, num_edges=E,
        block_nodes=BV, num_blocks=nb, block_edges=EB, kn=kn, klo=klo,
        khi=khi, max_degree=md,
        node_map=node_map, node_owned=node_owned, inc_edges=inc_e,
        inc_signs=inc_s, src=src_l, dst=dst_l, weights=w_l,
        edge_map=edge_map, edge_owned=edge_owned, orient=orient,
        send_rows=NS, send_idx=send_idx, send_flip=send_flip,
        recv_src=recv_src, recv_src_dense=recv_src_dense,
        recv_flip=recv_flip,
        w_sel=w_sel, u_sel=u_sel, u_flip=u_flip,
        w_inj=w_inj, u_inj=u_inj, u_inj_flip=u_inj_flip,
        cut_edges=int(cut.sum()), cut_fraction=float(cut.sum() / max(E, 1)),
        halo_nodes=halo, replicated_edges=replicated)


def permute_node_array(plan: PartitionPlan, arr: np.ndarray,
                       fill=0.0) -> np.ndarray:
    """Reorder+pad a (V, ...) array into the plan's (S * vp, ...) layout."""
    arr = np.asarray(arr)
    out = np.full((len(plan.node_perm),) + arr.shape[1:], fill,
                  dtype=arr.dtype)
    valid = plan.node_perm >= 0
    out[valid] = arr[plan.node_perm[valid]]
    return out


def unpermute_node_array(plan: PartitionPlan, arr: np.ndarray,
                         num_nodes: int) -> np.ndarray:
    """Inverse of permute_node_array (drops padding)."""
    arr = np.asarray(arr)
    out = np.empty((num_nodes,) + arr.shape[1:], dtype=arr.dtype)
    valid = plan.node_perm >= 0
    out[plan.node_perm[valid]] = arr[valid]
    return out


def permute_edge_array(plan: PartitionPlan, arr: np.ndarray,
                       fill=0.0) -> np.ndarray:
    """Reorder+pad an (E, ...) array into the plan's (S * ep, ...) layout."""
    arr = np.asarray(arr)
    out = np.full((len(plan.edge_perm),) + arr.shape[1:], fill,
                  dtype=arr.dtype)
    valid = plan.edge_perm >= 0
    out[valid] = arr[plan.edge_perm[valid]]
    return out


def unpermute_edge_array(plan: PartitionPlan, arr: np.ndarray,
                         num_edges: int) -> np.ndarray:
    """Inverse of permute_edge_array (drops padding)."""
    arr = np.asarray(arr)
    out = np.empty((num_edges,) + arr.shape[1:], dtype=arr.dtype)
    valid = plan.edge_perm >= 0
    out[plan.edge_perm[valid]] = arr[valid]
    return out


# ---------------------------------------------------------------------------
# Device-side permutes — the same layouts as the numpy helpers above, as
# gathers on the array's device, so warm-started / continuation solves
# never round-trip the solver state through the host.
# ---------------------------------------------------------------------------

def _index(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


def permute_node_array_device(plan: PartitionPlan, arr: torch.Tensor,
                              fill=0.0) -> torch.Tensor:
    """Tensor twin of :func:`permute_node_array`: (V, ...) -> (S*vp, ...)."""
    return gather_padded(arr, _index(plan.node_perm, arr.device), fill)


def unpermute_node_array_device(plan: PartitionPlan, arr: torch.Tensor,
                                num_nodes: int) -> torch.Tensor:
    """Tensor twin of :func:`unpermute_node_array`: a gather by node_inv."""
    return arr[_index(plan.node_inv, arr.device)]


def permute_edge_array_device(plan: PartitionPlan, arr: torch.Tensor,
                              fill=0.0) -> torch.Tensor:
    """Tensor twin of :func:`permute_edge_array`: (E, ...) -> (S*ep, ...)."""
    return gather_padded(arr, _index(plan.edge_perm, arr.device), fill)


def unpermute_edge_array_device(plan: PartitionPlan, arr: torch.Tensor,
                                num_edges: int) -> torch.Tensor:
    """Tensor twin of :func:`unpermute_edge_array`: a gather by edge_inv."""
    return arr[_index(plan.edge_inv, arr.device)]

"""Node orderings and padded permutes for the edge-blocked layout.

The port keeps its own copy of the host-side numpy planners of
``repro.core.partition`` (the reverse Cuthill-McKee order, its
structure-hash cache with the export/install pair that plan persistence
uses, and the serving layer's dual transfer across edge patches), so a
layout planned here is bit-identical to the reference's.  Only
:func:`gather_padded` touches tensors.
"""
from __future__ import annotations

from collections import OrderedDict, deque

import numpy as np
import torch

from repro_torch.device import to_host


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

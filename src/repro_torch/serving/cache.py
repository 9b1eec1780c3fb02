"""Plan cache for the solve service (the port's ``repro.serving.cache``).

A *plan* is everything a solve reuses that is expensive to rebuild but
independent of the node-local data: the RCM order (memoized in
``core.partition``) and the :class:`~repro_torch.core.graph.
EdgeBlockLayout` for the fused engine (with its compact incidence, which
the fused kernel reads).  Plans are keyed by

    (graph structure hash, loss, regularizer, backend, shape signature)

so two tenants serving the same graph *structure* with different data
share one plan, while any edge add/drop/reweight (new structure hash)
builds a fresh one.

Compile accounting rides the *executable signature* — the plan key minus
the structure hash — as in the reference, where XLA caches jitted
executables by static args and shapes, not by graph content.  The port
compiles nothing per signature, but the first solve of a signature in a
process pays the same kind of one-time cost: the kernel library's load,
the kernels' first launches, the library handles, and each tol solve's
CUDA-graph capture.  ``PlanCache`` meters it by the same rule (a
signature new to the process), so the
:class:`~repro_torch.serving.ledger.ServiceLedger` counts compiles
exactly as the reference's does on the same request sequence.

Persistence uses the reference's on-disk format (npz + manifest through
``repro_torch.checkpoint``, a ``plans.json`` of version 1): plans saved
by either package load in the other.  The compact incidence is not
saved (the reference has no such field): :meth:`PlanCache.load` rebuilds
it from the restored padded tables (``core/graph.py:with_compact``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from collections import OrderedDict
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.problem import Problem, SolverConfig
from repro_torch.core.graph import EdgeBlockLayout, with_compact
from repro_torch.device import resolve_device, to_host


@dataclasses.dataclass(frozen=True)
class PlanKey:
    """Cache key: structure + templates + backend + shapes.

    ``loss`` / ``regularizer`` are the template reprs (dataclass reprs
    are stable and capture parameters like a lasso alpha); ``shape_sig``
    is (V, E, m_max, n, max_degree) — the tuple that determines every
    array shape of the solve.  ``shard_sig`` is the reference's sharding
    facet for its distributed backends; the port serves the
    single-program engines only (``sharded`` is ROADMAP §1 item 9), so
    its own keys carry ``()``, and a loaded key keeps what it was saved
    with.
    """

    structure_hash: str
    loss: str
    regularizer: str
    backend: str
    shape_sig: tuple[int, int, int, int, int]
    shard_sig: tuple = ()

    @classmethod
    def for_problem(cls, problem: Problem,
                    config: SolverConfig) -> "PlanKey":
        g, d = problem.graph, problem.data
        return cls(
            structure_hash=g.structure_hash(),
            loss=repr(problem.loss),
            regularizer=repr(problem.regularizer),
            backend=config.backend,
            shape_sig=(g.num_nodes, g.num_edges, int(d.x.shape[1]),
                       int(d.x.shape[2]), g.max_degree),
        )

    @property
    def exec_sig(self) -> tuple:
        """The executable facet of the key (no structure hash)."""
        return (self.loss, self.regularizer, self.backend, self.shape_sig,
                self.shard_sig)


@dataclasses.dataclass
class Plan:
    """One cached solve plan.

    ``layout`` is the pre-planned edge-blocked layout (fused pallas
    engine; None for dense and the unfused engine, whose only plan state
    is the memoized RCM order).  ``uses`` counts lookups that returned this
    plan, hit or miss.
    """

    key: PlanKey
    layout: EdgeBlockLayout | None = None
    uses: int = 0


# EdgeBlockLayout field split for (de)serialization: python ints vs the
# device arrays that go through repro_torch.checkpoint (the reference's
# nine and nine; the compact incidence is rebuilt at load).
_LAYOUT_STATIC = ("block_nodes", "num_blocks", "block_edges", "kn", "klo",
                  "khi", "max_degree", "num_nodes", "num_edges")
_LAYOUT_ARRAYS = ("node_perm", "node_inv", "src", "dst", "weights",
                  "inc_edges", "inc_signs", "edge_pos", "edge_flip")


_TORCH_DTYPES = {"int32": torch.int32, "float32": torch.float32}


def _payload_hash(arrays: "OrderedDict[str, np.ndarray]") -> str:
    """Content hash of a named array bundle (shape/dtype/bytes)."""
    h = hashlib.blake2b(digest_size=16)
    for name, arr in arrays.items():
        arr = np.ascontiguousarray(arr)
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(np.asarray(arr.shape, np.int64).tobytes())
        h.update(arr.tobytes())
    return h.hexdigest()


def layout_structure_hash(layout: EdgeBlockLayout) -> str:
    """Recompute the *original* graph's structure hash from a layout.

    Inverts the edge-block relabeling: original edge e lives at owned
    position ``edge_pos[e]`` with endpoints in layout numbering, so
    mapping through ``node_perm`` and re-canonicalizing (min/max — the
    original graph stores src < dst) reproduces exactly the arrays
    :meth:`EmpiricalGraph.structure_hash` hashes.  Used to validate a
    deserialized plan against the structure hash it claims to serve.
    """
    node_perm = to_host(layout.node_perm).astype(np.int64)
    pos = to_host(layout.edge_pos).astype(np.int64)
    a = node_perm[to_host(layout.src).astype(np.int64)[pos]]
    b = node_perm[to_host(layout.dst).astype(np.int64)[pos]]
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(layout.num_nodes).tobytes())
    h.update(np.minimum(a, b).tobytes())
    h.update(np.maximum(a, b).tobytes())
    h.update(to_host(layout.weights).astype(np.float32)[pos].tobytes())
    return h.hexdigest()


class PlanCache:
    """LRU cache of :class:`Plan` objects, capped at ``max_entries``.

    ``get_or_build`` is the main entry point: it returns ``(plan, hit,
    compiled)`` where ``hit`` is a plan-cache hit and ``compiled`` marks
    a lookup whose executable signature is new to this *process* (the
    solve will pay the signature's first-solve cost).  A hit can still
    report ``compiled=True`` for a plan restored by :meth:`load` — plans
    persist across processes, loaded kernels and library state do not.

    :meth:`save`/:meth:`load` persist the plans (layouts + the RCM
    orders they were planned from) through ``repro_torch.checkpoint``,
    keyed and validated by structure hash.
    """

    def __init__(self, max_entries: int = 64):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        self.max_entries = int(max_entries)
        self._plans: OrderedDict[PlanKey, Plan] = OrderedDict()
        # exec sigs this process has solved.  Bounded LRU, as the
        # reference's: evicting a *plan* never forgets its signature, so
        # the bound is a generous multiple of the plan cap rather than
        # tied to it.
        self._compiled_sigs: OrderedDict[tuple, None] = OrderedDict()
        self.compiled_sigs_max = max(8 * self.max_entries, 64)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.loaded = 0

    def __len__(self) -> int:
        return len(self._plans)

    def __contains__(self, key: PlanKey) -> bool:
        return key in self._plans

    def mark_compiled(self, sig: tuple) -> bool:
        """Record an executable signature; True iff new to this process.

        Public so the batch runner can meter its own lane-stacked
        solves (their sig includes the batch width).
        """
        if sig in self._compiled_sigs:
            self._compiled_sigs.move_to_end(sig)
            return False
        self._compiled_sigs[sig] = None
        while len(self._compiled_sigs) > self.compiled_sigs_max:
            self._compiled_sigs.popitem(last=False)
        if obs.enabled():
            obs.counter("repro_plan_compiles_total",
                        help="executable signatures newly traced").inc()
        return True

    def get_or_build(self, key: PlanKey, build: Callable[[], Plan],
                     *, sig: tuple | None = None) -> tuple[Plan, bool, bool]:
        """Look up (or build) the plan for ``key``.

        ``sig`` overrides the executable signature being metered — the
        batch runner passes ``("batch", B) + key.exec_sig``, as the
        reference does: a B-lane solve is another signature than the
        singleton one, even over the same plan.
        """
        sig = key.exec_sig if sig is None else sig
        plan = self._plans.get(key)
        if plan is not None:
            self._plans.move_to_end(key)
            self.hits += 1
            plan.uses += 1
            if obs.enabled():
                self._export_obs(hit=True)
            # restored plans (cross-process load) hit here without this
            # process ever having solved the signature — still a compile
            return plan, True, self.mark_compiled(sig)
        self.misses += 1
        plan = build()
        # the sig is recorded only now: a failing build must not mark
        # its signature compiled, or the retry under-reports it
        compiled = self.mark_compiled(sig)
        plan.uses += 1
        self._plans[key] = plan
        while len(self._plans) > self.max_entries:
            self._plans.popitem(last=False)
            self.evictions += 1
        if obs.enabled():
            self._export_obs(hit=False)
        return plan, False, compiled

    def _export_obs(self, *, hit: bool) -> None:
        outcome = "hit" if hit else "miss"
        obs.counter("repro_plan_cache_lookups_total",
                    help="plan-cache lookups by outcome",
                    outcome=outcome).inc()
        obs.gauge("repro_plan_cache_entries",
                  help="plans currently cached").set(len(self._plans))

    # -- cross-process persistence ------------------------------------------
    def save(self, path: str) -> dict[str, int]:
        """Persist every cached plan (and its RCM order) to ``path``.

        Arrays go through ``repro_torch.checkpoint`` (npz + manifest); a
        ``plans.json`` sidecar records keys, layout statics, array specs
        and content hashes so :meth:`load` can rebuild and validate the
        exact layouts — the reference's format, field for field.
        Compiled-sig state is deliberately *not* saved: loaded kernels
        and captured graphs die with the process, and pretending
        otherwise would fake the compile accounting.
        """
        from repro_torch.checkpoint import checkpoint as ckpt
        from repro_torch.core.partition import export_rcm_orders

        trees: dict[str, dict[str, np.ndarray]] = {}
        plan_metas = []
        for idx, plan in enumerate(self._plans.values()):
            name = f"plan{idx}"
            entry: dict = {
                "name": name,
                "key": {
                    "structure_hash": plan.key.structure_hash,
                    "loss": plan.key.loss,
                    "regularizer": plan.key.regularizer,
                    "backend": plan.key.backend,
                    "shape_sig": list(plan.key.shape_sig),
                    "shard_sig": list(plan.key.shard_sig),
                },
                "layout": None,
            }
            if plan.layout is not None:
                arrays = OrderedDict(
                    (f, to_host(getattr(plan.layout, f)))
                    for f in _LAYOUT_ARRAYS)
                trees[name] = dict(arrays)
                entry["layout"] = {
                    "static": {f: int(getattr(plan.layout, f))
                               for f in _LAYOUT_STATIC},
                    "arrays": {f: {"shape": list(a.shape),
                                   "dtype": str(a.dtype)}
                               for f, a in arrays.items()},
                    "payload_hash": _payload_hash(arrays),
                }
            plan_metas.append(entry)

        # RCM orders for the structures we cache plans for (int32 storage,
        # as the reference's, whose restore has no 64-bit integers)
        hashes = {p.key.structure_hash for p in self._plans.values()}
        rcm_metas = []
        for idx, ((shash, reverse), order) in enumerate(
                sorted(export_rcm_orders(hashes).items())):
            name = f"rcm{idx}"
            arrays = OrderedDict(order=np.asarray(order, np.int32))
            trees[name] = dict(arrays)
            rcm_metas.append({
                "name": name, "structure_hash": shash,
                "reverse": bool(reverse), "shape": [int(len(order))],
                "payload_hash": _payload_hash(arrays),
            })

        ckpt.save(path, {name: {k: torch.from_numpy(np.ascontiguousarray(a))
                                for k, a in tree.items()}
                         for name, tree in trees.items()})
        with open(os.path.join(path, "plans.json"), "w") as f:
            json.dump({"version": 1, "plans": plan_metas,
                       "rcm_orders": rcm_metas}, f, indent=1, sort_keys=True)
        return {"plans": len(plan_metas), "rcm_orders": len(rcm_metas)}

    def load(self, path: str, device=None) -> dict[str, int]:
        """Restore plans saved by :meth:`save` (by either package) into
        this cache, their layouts on ``device`` (``None`` = CUDA).

        Every layout payload is content-hash checked, and every
        layout-bearing plan is re-validated against its claimed
        structure hash by *recomputing* the hash from the deserialized
        layout (:func:`layout_structure_hash`) — a stale or corrupted
        checkpoint raises instead of silently serving a wrong plan.
        The layout's compact incidence is rebuilt from its restored
        tables.  RCM orders are reinstalled into the ``core.partition``
        memo so any re-planning also skips the BFS.
        """
        from repro_torch.checkpoint import checkpoint as ckpt
        from repro_torch.core.partition import install_rcm_order

        dev = resolve_device(device)

        with open(os.path.join(path, "plans.json")) as f:
            meta = json.load(f)

        like: dict[str, dict[str, np.ndarray]] = {}
        for entry in meta["plans"]:
            if entry["layout"] is not None:
                like[entry["name"]] = {
                    f: torch.empty(spec["shape"],
                                   dtype=_TORCH_DTYPES[spec["dtype"]])
                    for f, spec in entry["layout"]["arrays"].items()}
        for entry in meta["rcm_orders"]:
            like[entry["name"]] = {
                "order": torch.empty(entry["shape"], dtype=torch.int32)}
        restored = ckpt.restore(path, like) if like else {}

        loaded = 0
        for entry in meta["plans"]:
            k = entry["key"]
            key = PlanKey(structure_hash=k["structure_hash"],
                          loss=k["loss"], regularizer=k["regularizer"],
                          backend=k["backend"],
                          shape_sig=tuple(int(s) for s in k["shape_sig"]),
                          # pre-shard_sig checkpoints load as single-
                          # program plans (the field's default)
                          shard_sig=tuple(k.get("shard_sig", [])))
            layout = None
            if entry["layout"] is not None:
                arrays = OrderedDict(
                    (f, restored[entry["name"]][f].numpy())
                    for f in _LAYOUT_ARRAYS)
                if _payload_hash(arrays) != entry["layout"]["payload_hash"]:
                    raise ValueError(
                        f"plan checkpoint corrupt: payload hash mismatch "
                        f"for {entry['name']} in {path}")
                layout = EdgeBlockLayout(
                    **{f: int(v)
                       for f, v in entry["layout"]["static"].items()},
                    **{f: torch.from_numpy(v).to(dev)
                       for f, v in arrays.items()})
                recomputed = layout_structure_hash(layout)
                if recomputed != key.structure_hash:
                    raise ValueError(
                        f"plan checkpoint stale: {entry['name']} claims "
                        f"structure {key.structure_hash} but its layout "
                        f"hashes to {recomputed}")
                layout = with_compact(layout, arrays["inc_edges"],
                                      arrays["inc_signs"])
            self._plans[key] = Plan(key=key, layout=layout)
            self._plans.move_to_end(key)
            loaded += 1
            while len(self._plans) > self.max_entries:
                self._plans.popitem(last=False)
                self.evictions += 1

        for entry in meta["rcm_orders"]:
            arrays = OrderedDict(
                order=restored[entry["name"]]["order"].numpy())
            if _payload_hash(arrays) != entry["payload_hash"]:
                raise ValueError(
                    f"plan checkpoint corrupt: payload hash mismatch for "
                    f"{entry['name']} in {path}")
            install_rcm_order(entry["structure_hash"], arrays["order"],
                              reverse=entry["reverse"])

        self.loaded += loaded
        return {"plans": loaded, "rcm_orders": len(meta["rcm_orders"])}

    def summary(self) -> dict[str, float]:
        total = self.hits + self.misses
        return {
            "entries": float(len(self._plans)),
            "hits": float(self.hits),
            "misses": float(self.misses),
            "hit_rate": float(self.hits / total) if total else 0.0,
            "evictions": float(self.evictions),
            "compiled_sigs": float(len(self._compiled_sigs)),
            "loaded": float(self.loaded),
        }

"""The deployment's empirical graph: a stochastic block model drawn from
the configuration's fixed ``graph_seed``, kept in a cache inside the
checkout together with the program's plan for it.

The recipe is the repository's scale-out topology (``benchmarks/
scaling.py:_make_clustered``): clusters of ``cluster_nodes`` nodes, each
pair of a cluster joined with probability degree / cluster size, pairs
across clusters with probability 2 * cross_edges_per_node / V; each
cluster pair draws its edge count from a binomial and that many uniform
endpoint pairs, self-pairs dropped and duplicates merged.  It is drawn
here with one numpy generator in a few vectorized calls, not by the
program.

The first run of a configuration in a checkout draws the graph, hands it
to the program (``core.graph.build_graph``), has the program plan it (a
solve service's first solve) and saves the raw edge list (``edges.pt``)
and the program's plans (``PlanCache.save``, ``plans/``).  Every run
loads the edge list and has ``build_graph`` make the program's graph of
it; the plans it loads.  The cache
directory is fixed, one a configuration, named by a hash of the
configuration file's graph section.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path

import numpy as np

CACHE = Path(__file__).resolve().parent / "cache"

#: nodes of the problem a first run solves before it draws the graph
WARM_NODES = 64


def draw_edges(graph: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The SBM of ``graph`` (the configuration's graph section).
    Returns (src, dst, assign): int64 endpoints with src < dst, sorted
    and without duplicates, and each node's cluster."""
    v = int(graph["nodes"])
    rng = np.random.default_rng(int(graph["graph_seed"]))
    nc = max(v // int(graph["cluster_nodes"]), 1)
    sizes = np.full(nc, v // nc, np.int64)
    sizes[-1] += v - int(sizes.sum())
    offs = np.concatenate([[0], np.cumsum(sizes)])
    assign = np.repeat(np.arange(nc), sizes)
    p_in = min(float(graph["degree"]) / (v / nc), 1.0)
    p_out = min(2.0 * float(graph["cross_edges_per_node"]) * v / (v * v),
                1.0)
    # inside clusters: a binomial count a cluster, uniform pairs
    counts = rng.binomial(sizes * (sizes - 1) // 2, p_in)
    cl = np.repeat(np.arange(nc), counts)
    a = offs[cl] + (rng.random(cl.size) * sizes[cl]).astype(np.int64)
    b = offs[cl] + (rng.random(cl.size) * sizes[cl]).astype(np.int64)
    # across clusters: a binomial count over all cross pairs, uniform
    # node pairs, those inside one cluster redrawn
    cross_pairs = (v * v - int((sizes * sizes).sum())) // 2
    k = int(rng.binomial(cross_pairs, p_out))
    ca = rng.integers(0, v, size=k)
    cb = rng.integers(0, v, size=k)
    same = assign[ca] == assign[cb]
    while same.any():
        cb[same] = rng.integers(0, v, size=int(same.sum()))
        same = assign[ca] == assign[cb]
    a, b = np.concatenate([a, ca]), np.concatenate([b, cb])
    keep = a != b
    lo, hi = np.minimum(a, b)[keep], np.maximum(a, b)[keep]
    key = np.unique(lo * v + hi)
    return key // v, key % v, assign


def cache_dir(config: dict) -> Path:
    """The configuration's fixed cache directory."""
    h = hashlib.sha256(json.dumps(
        {"graph": config["graph"], "loss": config["loss"],
         "samples": config["samples"], "features": config["features"]},
        sort_keys=True).encode()).hexdigest()[:12]
    return CACHE / f"{config['name']}-{h}"


def load_or_build(config: dict, device, make_problem, plan_config):
    """The configuration's graph and plans on ``device``.

    Returns ``(topo, graph, plans_dir, build_s)``: ``topo`` the raw edge
    list (src, dst, weights, assign as tensors on ``device``) that the
    reference reads, ``graph`` the program's ``EmpiricalGraph`` built
    from it by ``build_graph`` (every run), ``plans_dir`` the saved plans
    (``PlanCache.load`` reads them), ``build_s`` the seconds this run
    spent drawing, planning and saving them (None where it loaded them).
    ``make_problem(graph, assign)`` makes a problem for the first run's
    planning solve; ``plan_config`` is its solver config.  That run
    first solves a problem of ``WARM_NODES`` nodes, which builds the
    program's kernels outside ``build_s``: compilation is set-up.
    """
    import torch
    from repro_torch.api import Solver
    from repro_torch.core.graph import build_graph
    from repro_torch.serving import SolveService

    def program_graph(src, dst, weights, nodes):
        return build_graph(np.stack([src, dst], 1), weights, nodes,
                           device=device)

    d = cache_dir(config)
    build_s = None
    if not (d / "done").exists():
        small = dict(config["graph"], nodes=WARM_NODES,
                     cluster_nodes=WARM_NODES // 2)
        src, dst, assign = draw_edges(small)
        Solver(plan_config).run(make_problem(program_graph(
            src, dst, np.ones(src.shape, np.float32), WARM_NODES),
            assign)).w.cpu()
        t0 = time.perf_counter()
        part = d.with_name(d.name + ".partial")
        shutil.rmtree(part, ignore_errors=True)
        shutil.rmtree(d, ignore_errors=True)
        part.mkdir(parents=True)
        src, dst, assign = draw_edges(config["graph"])
        weights = np.ones(src.shape, np.float32)
        svc = SolveService(config=plan_config)
        sid = svc.create_session("plan", make_problem(program_graph(
            src, dst, weights, int(config["graph"]["nodes"])), assign))
        svc.solve(sid)
        svc.save_plans(str(part / "plans"))
        torch.save({"src": torch.from_numpy(src.astype(np.int32)),
                    "dst": torch.from_numpy(dst.astype(np.int32)),
                    "weights": torch.from_numpy(weights),
                    "assign": torch.from_numpy(assign.astype(np.int32))},
                   part / "edges.pt")
        (part / "done").write_text("ok\n")
        os.replace(part, d)
        del svc
        build_s = time.perf_counter() - t0
    saved = torch.load(d / "edges.pt")
    graph = program_graph(saved["src"].numpy(), saved["dst"].numpy(),
                          saved["weights"].numpy(),
                          int(config["graph"]["nodes"]))
    topo = {k: v.to(device) for k, v in saved.items()}
    return topo, graph, str(d / "plans"), build_s

"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
the same configuration and traffic files, the graph's nodes and cluster
size cut, the tol solves' budget and tol cut with them (a tiny graph's
plain step is slow on the CPU), a sweep's phases cut to 100 iterations
each, at most 4 datasets in the pool, its cache in a temporary
directory."""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import bench, topology  # noqa: E402

NODES, CLUSTER, BUDGET, TOL, SWEEP = 1200, 200, 600, 0.1, 100


def tiny_cell(name: str, nodes: int = NODES) -> bench.Cell:
    cell = bench.Cell.load(name)
    cfg = dict(cell.config)
    cfg["graph"] = dict(cfg["graph"], nodes=nodes, cluster_nodes=CLUSTER)
    cfg["budget"], cfg["tol"] = BUDGET, TOL
    traffic = dict(cell.traffic, pool=min(int(cell.traffic["pool"]), 4))
    if traffic["kind"] == "path":
        traffic.update(warm_iters=SWEEP, final_iters=SWEEP)
    return dataclasses.replace(cell, config=cfg, traffic=traffic)


def run_tiny(name: str, cache: Path, *, seed: int = 4_000_000_007,
             fault=None, dtype=None, calls: int = 3, trace: bool = False):
    """One run of the tiny cell on the CPU, ``calls`` calls long."""
    old = topology.CACHE
    topology.CACHE = cache
    try:
        return bench.run_cell(tiny_cell(name), seed=seed, seconds=1e9,
                              trace=trace, device="cpu",
                              t_start=time.perf_counter(), fault=fault,
                              dtype=dtype, max_calls=calls)
    finally:
        topology.CACHE = old

"""The benchmark of ``repro_torch``: one cell of ``BENCHMARK.json`` a run.

A cell names a configuration (``configs/<config>.json``: the deployment
and the solver settings), a traffic mix (``traffic/<traffic>.json``,
whose ``kind`` names the closed loop in ``kinds/<kind>.py``) and the
chips it needs.  A run loads the configuration's graph and plans (built
and saved on the first run in a checkout, ``topology.py``, whose seconds
are reported apart from ``setup_s`` as ``first_build_s``), draws the
traffic's datasets from ``--seed`` on the device, warms the loop up at
the cell's shapes, measures ``--seconds`` of it, and then judges what
the timed calls answered against the plain reference (``ref/``).
With ``--trace 0`` the result carries the cell's end-to-end metrics;
with ``--trace 1`` the window runs under ``torch.profiler`` and the
result carries the per-layer metrics, each read by its own file,
``metrics/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names the process may not hold once the window has
#: closed (the JAX package is the reference the port was made from; the
#: benchmark measures the port alone)
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")

#: the window's bounds in a trace
WINDOW_START, WINDOW_END = "bench_window_start", "bench_window_end"

#: seconds of a traced run's window that run under ``torch.profiler``
#: (the calls that start in them); the rest of the window runs
#: untraced.  A profiler over whole 51 s windows of tol solves ended in
#: an illegal memory access on the H100 (six runs of six); 10 s ran clean.
TRACE_SECONDS = 10.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    name: str
    config: dict
    traffic: dict
    chips: int
    spec: dict

    @classmethod
    def load(cls, workload: str, root: Path = ROOT) -> "Cell":
        """The cell ``workload`` of ``root``'s ``BENCHMARK.json``."""
        spec = load_json(root / "BENCHMARK.json")
        cells = {w["name"]: w for w in spec["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}; "
                             f"BENCHMARK.json has {sorted(cells)}")
        w = cells[workload]
        configs = {c["name"]: c for c in spec["configs"]}
        config = load_json(root / configs[w["config"]]["file"])
        traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
        return cls(name=workload, config=config, traffic=traffic,
                   chips=int(w["chips"]), spec=spec)

    def end_to_end(self) -> list:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.spec["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.spec["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


def kind_module(traffic: dict):
    return importlib.import_module(f"perfbench.kinds.{traffic['kind']}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read`` function."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Reservoir:
    """A sample of fixed size of the calls of a window, drawn from the
    seed as the calls come (Algorithm R); ``items`` maps each kept
    call's index to what it kept."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng([int(seed), 11])
        self.size = int(size)
        self.items: dict = {}
        self.seen = 0

    def offer(self, i: int, make) -> None:
        n, self.seen = self.seen, self.seen + 1
        if len(self.items) < self.size:
            self.items[i] = make()
            return
        j = int(self.rng.integers(0, n + 1))
        if j < self.size:
            del self.items[sorted(self.items)[j]]
            self.items[i] = make()


class Context:
    """What a traffic kind needs: the configuration, the traffic, the
    graph with its plans, the datasets, the program's settings and the
    reference's."""

    def __init__(self, cell: Cell, seed: int, device, *, dtype=None):
        import torch

        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.seed, self.device = int(seed), torch.device(device)
        c = self.config
        self.dtype = dtype or c["dtype"]
        self.tol, self.budget = float(c["tol"]), int(c["budget"])
        self.metric_every = int(c["metric_every"])
        self.features = int(c["features"])
        self.load_plans_s = None
        self.sampler = Reservoir(seed, int(cell.traffic["checked"]))

    # -- the program's side -------------------------------------------------
    def load_graph(self) -> float | None:
        """The graph and the path of its plans.  Returns the seconds this
        run spent drawing, planning and saving them (the first run of
        the configuration in a checkout), None where it loaded them."""
        from perfbench import topology

        self.topo, self.graph, self.plans_dir, build_s = \
            topology.load_or_build(self.config, self.device,
                                   self._planning_problem,
                                   self.solver_config())
        from perfbench.data import true_weights
        self.w_true = true_weights(self.config, self.topo["assign"])
        return build_s

    def _planning_problem(self, graph, assign):
        """A problem on ``graph`` (of any size) with a dataset of seed 0."""
        import torch

        from perfbench.data import make_pool
        config = dict(self.config, graph=dict(self.config["graph"],
                                              nodes=graph.num_nodes))
        ds = make_pool(config, torch.from_numpy(assign).to(self.device),
                       0, 1)[0]
        return self._problem(graph, ds)

    def draw_pool(self) -> None:
        """The traffic's ``pool`` datasets, drawn from the seed; the run
        keeps only the generator's state before each (``dataset``)."""
        from perfbench.data import pool_states
        self.states = pool_states(self.config, self.topo["assign"],
                                  self.seed, int(self.traffic["pool"]))

    def dataset(self, p: int):
        """Dataset ``p`` of the pool, drawn again on the device."""
        from perfbench.data import redraw
        return redraw(self.config, self.w_true, self.states[p])

    def attach_plan(self) -> None:
        """Load the saved plans and attach this graph's to it (the solver
        kinds; a solve service loads them itself)."""
        from repro_torch.serving import PlanCache
        from repro_torch.serving.cache import PlanKey

        cache = PlanCache()
        t0 = time.perf_counter()
        cache.load(self.plans_dir, device=self.device)
        self.load_plans_s = time.perf_counter() - t0
        key = PlanKey.for_problem(self._problem(self.graph,
                                                self.dataset(0)),
                                  self.solver_config())

        def missing():
            raise RuntimeError(f"no saved plan for {key} in "
                               f"{self.plans_dir}")
        plan, _, _ = cache.get_or_build(key, missing)
        self.graph = dataclasses.replace(self.graph, layout=plan.layout)

    def solver_config(self, **over):
        from repro_torch.api import SolverConfig

        c = self.config
        kw = dict(backend="pallas", fused=True, num_iters=self.budget,
                  rho=float(c["rho"]), metric_every=self.metric_every,
                  tol=self.tol, dtype=self.dtype)
        kw.update(over)
        return SolverConfig(**kw)

    def _problem(self, graph, ds):
        import torch
        from repro_torch.api import Problem
        from repro_torch.core.losses import NodeData

        ones = getattr(self, "_ones", None)
        if ones is None or ones.shape != ds.y.shape:
            # every sample counts: one mask for every problem
            ones = self._ones = torch.ones(ds.y.shape, device=ds.y.device)
        data = NodeData(x=ds.x, y=ds.y, sample_mask=ones,
                        labeled_mask=ds.labeled.to(torch.float32))
        return Problem.create(graph, data, float(self.config["lam"]),
                              loss=self.config["loss"], device=self.device,
                              **self.config.get("loss_kwargs", {}))

    def problem(self, ds, plan: bool = True):
        """The program's problem of dataset ``ds`` on this run's graph
        (with its plan attached unless ``plan`` is False)."""
        graph = self.graph if plan else dataclasses.replace(
            self.graph, layout=None)
        return self._problem(graph, ds)

    # -- the reference's side -----------------------------------------------
    def reference(self, ds, lam=None):
        """The plain reference on the raw edge list and ``ds``, in
        float64, at the configuration's lambda or ``lam``."""
        import torch

        from perfbench.ref.alg1 import Alg1
        c = self.config
        return Alg1(self.topo["src"], self.topo["dst"], self.topo["weights"],
                    ds.x, ds.y, ds.labeled, loss=c["loss"],
                    lams=float(c["lam"]) if lam is None else lam,
                    rho=float(c["rho"]),
                    loss_kwargs=c.get("loss_kwargs", {}),
                    dtype=torch.float64)


@dataclasses.dataclass
class Measured:
    """What a run measured, handed to the per-layer metric readers."""

    cell: Cell
    ctx: Context
    records: list
    window_s: float
    trace: object = None
    traced_records: list = dataclasses.field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.cell.traffic["kind"]

    def step_work(self, lanes: int = 1) -> dict:
        from perfbench import work
        from perfbench.data import labeled_count
        c = self.cell.config
        return work.step_work(
            nodes=int(c["graph"]["nodes"]), edges=int(self.ctx.topo[
                "src"].shape[0]), n=int(c["features"]),
            m=int(c["samples"]), labeled=labeled_count(c), loss=c["loss"],
            lanes=lanes, dtype=self.ctx.dtype,
            loss_kwargs=c.get("loss_kwargs", {}))

    def least_window_seconds(self) -> float:
        """The least time the H100 could take for every iteration the
        window's calls ran: one-lane iterations (solves, requests, a
        sweep's warm phase) and lane-steps of a sweep."""
        from perfbench import work
        one = sum(r.get("iterations", 0) + r.get("one_lane_iterations", 0)
                  for r in self.records)
        total = one * work.least_seconds(self.step_work())
        for r in self.records:
            if r.get("lane_step_iterations"):
                total += r["lane_step_iterations"] * work.least_seconds(
                    self.step_work(r["lanes"]))
        return total


def check_modules() -> list:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN_MODULES})


def run_cell(cell: Cell, *, seed: int, seconds: float, trace: bool,
             device, t_start: float, dtype=None, fault=None,
             max_calls: int | None = None) -> dict:
    """One run of ``cell``: returns the result object (the JSON line's
    content) with the compared numbers under ``compared``.  ``fault``
    (``faults.py``) breaks the timed path underneath; ``dtype`` runs the
    program in another storage precision (the control)."""
    import torch

    from perfbench import devtrace, faults

    ctx = Context(cell, seed, device, dtype=dtype)
    kind = kind_module(cell.traffic)
    phases = {"start": time.perf_counter() - t_start}
    build_s = ctx.load_graph()
    phases["graph"] = time.perf_counter() - t_start
    ctx.draw_pool()
    phases["pool"] = time.perf_counter() - t_start
    if not getattr(kind, "LOADS_PLANS", False):
        ctx.attach_plan()
    phases["plans"] = time.perf_counter() - t_start
    cuda = ctx.device.type == "cuda"
    with faults.applied(fault):
        st = kind.setup(ctx)
        if cuda:
            torch.cuda.synchronize()
        phases["warm_up"] = time.perf_counter() - t_start
        # a first run's drawing, planning and saving are reported apart
        setup_s = phases["warm_up"] - (build_s or 0.0)
        records, prof, traced = [], None, None
        if trace:
            prof = start_profiler()
            mark(WINDOW_START)
        t0 = time.perf_counter()
        while True:
            with range_of(f"bench.{cell.traffic['kind']}"):
                records.append(kind.call(ctx, st, len(records)))
            elapsed = time.perf_counter() - t0
            if traced is None and prof is not None and (
                    elapsed >= min(seconds, TRACE_SECONDS)
                    or len(records) == max_calls):
                mark(WINDOW_END)
                prof.stop()
                traced = len(records)
            if elapsed >= seconds or (
                    max_calls and len(records) >= max_calls):
                break
        window_s = time.perf_counter() - t0
        tr = None
        if trace:
            t_read = time.perf_counter()
            tr = devtrace.from_profiler(prof, WINDOW_START, WINDOW_END)
            phases["trace_read_s"] = time.perf_counter() - t_read
            del prof
        peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        # the reference's own allocations come after the reading
        found = check_modules()
        if found:
            raise ForbiddenModules(found)
        measured = Measured(cell=cell, ctx=ctx, records=records,
                            window_s=window_s, trace=tr,
                            traced_records=records[:traced or 0])
        metrics = {}
        if trace:
            for m in cell.per_layer():
                value = metric_reader(m["name"])(measured)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value),
                                          "unit": m["unit"]}
        else:
            e2e = kind.end_to_end(records, window_s)
            e2e["setup_s"] = setup_s
            for m in cell.end_to_end():
                metrics[m["name"]] = {"value": float(e2e[m["name"]]),
                                      "unit": m["unit"]}
        # the program's state goes before the reference runs
        for key in [k for k in st if k not in kind.CHECK_READS]:
            del st[key]
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        numbers = kind.check(ctx, st, records)
        phases["check_s"] = time.perf_counter() - t_check
    limits = load_json(HERE / "limits" / f"{cell.name}.json")
    # a number that is not finite fails, and is printed as the largest
    # float JSON takes
    compared = {k: {"value": float(v) if math.isfinite(v) else 1e308,
                    "limit": float(limits[k])}
                for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in compared.values())
    failed = sum(1 for r in records if not r["met"])
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name(ctx.device) if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": len(records),
           "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = tr.busy_s() if tr else 0.0
        device_info["window_s"] = tr.window_s if tr else window_s
        out["breakdown"] = {"device_ops": tr.top_ops(10),
                            "idle_gaps": tr.idle_gaps(10)}
    out["notes"] = {"calls": len(records), "window_s": window_s,
                    "traced_calls": traced,
                    "first_build_s": build_s,
                    "load_plans_s": ctx.load_plans_s,
                    "setup_phases_s": phases,
                    "iterations": [r.get("iterations") for r in records],
                    "seconds": [r["seconds"] for r in records]}
    if hasattr(kind, "notes"):
        out["notes"].update(kind.notes(records))
    if trace:
        out["notes"]["trace_ops"] = len(tr.ops)
        counts = {}
        for name, _, _ in tr.ops:
            k = devtrace.short(name)
            counts[k] = counts.get(k, 0) + 1
        out["notes"]["op_counts"] = dict(sorted(
            counts.items(), key=lambda kv: -kv[1])[:12])
    out["compared"] = compared
    return out


class ForbiddenModules(RuntimeError):
    """The process holds a module of a forbidden top-level name."""


def start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def mark(name: str) -> None:
    import torch
    with torch.profiler.record_function(name):
        pass


def range_of(name: str):
    """A host range of the harness's own around its calls into the
    program (a no-op context unless a profiler records)."""
    import contextlib

    import torch
    if not torch.autograd._profiler_enabled():
        return contextlib.nullcontext()
    return torch.profiler.record_function(name)

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (``fused_pd_step``, ``tv_prox``,
``batched_affine``) from this checkout into one library, holds each
against its plain PyTorch version on the card, and drives both kernel
paths of ``Solver(SolverConfig(backend="pallas", ...)).run``: the fused
primal-dual solve and the unfused one (the dense loop with ``tv_prox``
and ``batched_affine`` wired in).  Each runs on the paper's §5 instance,
the unfused one also on the eight scenarios of the zoo, and both at full
size (1,000,000 nodes, ~10.2M edges, one instance shared by the two),
each against the dense backend on the card.  Each phase prints one JSON
line with its seconds; any mismatch or error exits non-zero before the
result.  The last three lines are the kernels' line, the card's name and
power limit (``nvidia-smi``), and ``{"ok": true, "device": {...}}``.

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without printing a result when there is no card, or when it is run
outside a checkout of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL_NODES = 1_000_000
STEP_TOL = 1e-5            # kernel vs plain version, one call
SOLVE_TOL = 1e-4           # fused vs dense; one metric block at full size
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
KERNELS = {
    "fused_pd_step": {"name": "fused_pd_step", "route": "cuda",
                      "source": "src/repro_torch/csrc/pd_step.cu",
                      "replaces": "src/repro/kernels/pd_step.py:144"},
    "tv_prox": {"name": "tv_prox", "route": "cuda",
                "source": "src/repro_torch/csrc/tv_prox.cu",
                "replaces": "src/repro/kernels/tv_prox.py:26"},
    "batched_affine": {"name": "batched_affine", "route": "cuda",
                       "source": "src/repro_torch/csrc/ridge_prox.cu",
                       "replaces": "src/repro/kernels/ridge_prox.py:33"},
}
AFFINE_TOL = 1e-5          # batched_affine vs plain version (summation order)
ZOO_OBJ_RTOL = 1e-5        # unfused vs dense objective traces, zoo
L2_BYTES = 50e6            # H100 L2 cache
# the §5 shapes of the port's kernel tests (tests/test_torch_kernels.py)
TV_SHAPES = [(7, 2), (512, 2), (1000, 16), (33, 5), (1, 1), (65, 3)]
AFFINE_SHAPES = [(300, 2), (64, 8), (1000, 32), (13, 3), (1, 1), (65, 3)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, copies: int = 1) -> float:
    """Mean milliseconds per call of ``fn(i)`` on the card (CUDA events,
    after one warm-up call of each input copy); call ``r`` gets copy
    ``r % copies``, so inputs smaller than L2 can be timed cold."""
    import torch
    for i in range(copies):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for r in range(reps):
        fn(r % copies)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_profile(torch, fn, reps: int, top: int = 10) -> dict:
    """Kernel time by name over ``reps`` calls of ``fn(i)`` from
    torch.profiler on the card: a warm-up cycle (the tracer drops events
    while it starts), then one recorded cycle.  Per kernel, the launches
    recorded per call and the device time per launch and per call; and
    the device's busy share of the recorded cycle's wall time (one
    stream, so kernel times add up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn(0)
    torch.cuda.synchronize()
    recorded = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: recorded.update(
                     events=p.key_averages())) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            for r in range(reps):
                fn(r)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.step()
    rows = sorted(((e.key, e.count, e.self_device_time_total)
                   for e in recorded["events"]
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0
                   # the step marker spans the kernels it contains
                   and not e.key.startswith("ProfilerStep")),
                  key=lambda r: -r[2])
    busy_us = sum(r[2] for r in rows)
    return {"reps": reps, "wall_ms_per_call": wall * 1e3 / reps,
            "device_ms_per_call": busy_us / 1e3 / reps,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernels": [{"name": k[:100], "launches_per_call": c / reps,
                         "device_ms_per_launch": us / 1e3 / c,
                         "device_ms_per_call": us / 1e3 / reps}
                        for k, c, us in rows[:top]]}


def max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def step_inputs(v, n, bv, seed, device):
    """Storage tensors of one fused step on a small SBM (the shapes of
    the port's kernel tests), squared-loss params ("b", "p")."""
    import torch
    from repro_torch.core.graph import plan_edge_blocks, sbm_graph

    rng = np.random.default_rng(seed)
    g, _ = sbm_graph(rng, (v // 2, v - v // 2), 0.3, 0.03, device=device)
    lt = plan_edge_blocks(g, block_nodes=bv)

    def rand(*shape, scale=1.0):
        a = scale * rng.standard_normal(shape)
        return torch.from_numpy(a.astype(np.float32)).to(device)

    eb = lt.block_edges
    deg = (lt.inc_signs != 0).sum(1).float()
    tau = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                      torch.ones_like(deg))
    u_store = torch.zeros(((lt.num_blocks + lt.klo + lt.khi) * eb, n),
                          device=device)
    u_store[lt.klo * eb:lt.klo * eb + lt.edges_pad] = rand(
        lt.edges_pad, n, scale=0.1)
    eye = torch.eye(n, device=device)
    args = (lt.pad_node_store(rand(lt.nodes_pad, n)), u_store,
            lt.pad_node_store(lt.inc_edges), lt.pad_node_store(lt.inc_signs),
            (lt.pad_node_store(rand(lt.nodes_pad, n, scale=0.1)),
             lt.pad_node_store(rand(lt.nodes_pad, n, n, scale=0.1) + eye)),
            lt.pad_node_store(tau[:, None]), lt.src[:, None],
            lt.dst[:, None], torch.full((lt.edges_pad, 1), 0.5,
                                        device=device),
            (0.1 * lt.weights)[:, None])
    kw = dict(pkeys=("b", "p"), block_nodes=lt.block_nodes,
              block_edges=eb, kn=lt.kn, klo=lt.klo, khi=lt.khi)
    return args, kw


def make_clustered(v: int, seed: int, device):
    """The repo's scale-out topology (``benchmarks/scaling.py:
    _make_clustered``): an SBM with ~2000-node clusters, degree ~20.5,
    0.007*V expected cross edges; n = 2, m_i = 5, 10% of nodes labeled,
    noiseless labels from a per-cluster (2,2) / (-2,2) ground truth."""
    import torch
    from repro_torch.core.graph import sbm_graph_sparse
    from repro_torch.core.losses import NodeData

    cross_edges = 0.007 * v
    rng = np.random.default_rng(seed)
    nc = max(v // 2000, 1)
    cs = [v // nc] * nc
    cs[-1] += v - sum(cs)
    g, assign = sbm_graph_sparse(
        rng, tuple(cs), p_in=min(20.5 / (v / nc), 1.0),
        p_out=min(2.0 * cross_edges / (v * v), 1.0), device=device)
    w_true = np.where(assign[:, None] % 2 == 0, [2.0, 2.0],
                      [-2.0, 2.0]).astype(np.float32)
    x = rng.standard_normal((v, 5, 2)).astype(np.float32)
    y = np.einsum("vmn,vn->vm", x, w_true)
    labeled = np.zeros(v, np.float32)
    labeled[rng.choice(v, size=max(v // 10, 10), replace=False)] = 1.0
    data = NodeData(x=torch.from_numpy(x), y=torch.from_numpy(y),
                    sample_mask=torch.ones((v, 5)),
                    labeled_mask=torch.from_numpy(labeled)).to(device)
    return g, data, torch.from_numpy(w_true).to(device)


def bound(read: int, written: int, flops: int) -> dict:
    """The least time on an H100 for a function that must move these
    bytes and do these float operations."""
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes_read": read, "bytes_written": written, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def step_cost(args, kw) -> dict:
    """The least time one ``iters=1`` call could take on an H100: bytes
    it must move (each input read once, each output written once) over
    the memory rate, against the float operations this data needs over
    the f32 rate.  The incidence counts its filled slots only, as the
    function needs them: an int32 id and an f32 sign per slot plus int32
    row offsets (CSR); the padded tables the kernel reads are reported
    beside it."""
    w_store, u_store, inc_e, inc_s, (b, p), tau, src, dst, sg, la = args
    nb = src.shape[0] // kw["block_edges"]
    n = w_store.shape[1]
    nodes, edges = nb * kw["block_nodes"], nb * kw["block_edges"]
    filled = int((inc_s != 0).sum())
    incidence = 8 * filled + 4 * (inc_s.shape[0] + 1)
    read = incidence + sum(t.numel() * t.element_size() for t in
                           (w_store, u_store, b, p, tau, src, dst, sg, la))
    written = 4 * n * (nodes + edges)
    flops = (2 * filled * n                     # signed gather-sum D^T u
             + nodes * (2 * n * n + 6 * n)      # prox, z, KM
             + edges * 9 * n)                   # D z, resolvent, KM
    return {**bound(read, written, flops),
            "incidence_bytes_filled": incidence,
            "incidence_bytes_padded": (inc_e.numel() * inc_e.element_size()
                                       + inc_s.numel() * inc_s.element_size())}


def phase_build(torch) -> None:
    """All kernel sources into one library, with ``-Xptxas -v``."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    lib, logs = _build.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc_flags": " ".join(_build.NVCC_FLAGS),
          "sources": [str(p.relative_to(ROOT)) for p in _build.sources()],
          "library": str(lib.relative_to(ROOT)),
          "ptxas": {name: [ln.strip() for ln in log.splitlines()
                           if "Compiling entry" in ln or "registers" in ln
                           or "spill" in ln]
                    for name, log in logs.items()}})
    require(sorted(logs) == ["pd_step.cu", "ridge_prox.cu", "tv_prox.cu"],
            f"built sources {sorted(logs)}")


def box_draw(level, n: int, seed: int):
    """u (E, n) uniform in twice its box [-2 b_e, 2 b_e] for clip levels
    b = ``level``: about half the entries clip."""
    import torch
    gen = torch.Generator(device=level.device).manual_seed(seed)
    return level[:, None] * (4.0 * torch.rand(
        (level.shape[0], n), generator=gen, device=level.device) - 2.0)


def affine_inputs(v, n, seed, device, p=None, v_scale=1.0):
    """p ~ N(0, 1) (or the given p), v ~ N(0, v_scale^2)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    if p is None:
        p = torch.randn((v, n, n), generator=gen, device=device)
    return p, v_scale * torch.randn((v, n), generator=gen, device=device)


def phase_kernel_vs_plain(torch, dev) -> dict:
    """Every kernel option against the plain version; returns the max
    error seen per kernel."""
    from repro_torch.api.losses import SquaredLoss
    from repro_torch.api.regularizers import SquaredTV, TotalVariation
    from repro_torch.kernels.pd_step import fused_pd_step
    from repro_torch.kernels.ref import (batched_affine_ref,
                                         fused_pd_step_ref, tv_prox_ref)
    from repro_torch.kernels.ridge_prox import batched_affine
    from repro_torch.kernels.tv_prox import tv_prox

    t0 = time.perf_counter()
    regs = {"tv": TotalVariation(), "tv2": SquaredTV()}
    cases = [(v, n, bv, rho, reg, 1)
             for v, n, bv in ((61, 2, 16), (103, 3, 32), (40, 4, 64))
             for rho in (1.0, 1.9) for reg in regs]
    cases += [(48, 2, None, 1.9, reg, 5) for reg in regs]
    rows, err = [], 0.0
    for v, n, bv, rho, reg, iters in cases:
        args, kw = step_inputs(v, n, bv, seed=v, device=dev)
        kw.update(loss=SquaredLoss(), reg=regs[reg], rho=rho, iters=iters,
                  compute_residual=True)
        got = fused_pd_step(*args, **kw)
        want = fused_pd_step_ref(*args, **kw)
        torch.cuda.synchronize()
        dw, du = max_diff(got[0], want[0]), max_diff(got[1], want[1])
        # the residual is a max of ratios (|dw|/tau, |du|/sigma) of order
        # 1-10: held to the same digits, relative to its size
        dr = max_diff(got[2], want[2]) / max(1.0, float(want[2].abs()))
        rows.append({"v": v, "n": n, "bv": bv, "rho": rho, "reg": reg,
                     "iters": iters, "dw": dw, "du": du, "dres_rel": dr})
        require(max(dw, du, dr) <= STEP_TOL,
                f"kernel vs plain version {rows[-1]}")
        err = max(err, dw, du)

    tv_rows, tv_err = [], 0.0
    for e, n in TV_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(e)
        level = torch.randn(e, generator=gen, device=dev).abs()
        u = box_draw(level, n, seed=e)
        d = max_diff(tv_prox(u, level), tv_prox_ref(u, level))
        clipped = float((u.abs() > level[:, None]).float().mean())
        tv_rows.append({"e": e, "n": n, "max_abs_err": d,
                        "clipped_share": clipped})
        require(d == 0.0, f"tv_prox vs plain version {tv_rows[-1]}")
        tv_err = max(tv_err, d)
    affine_rows, affine_err = [], 0.0
    for v, n in AFFINE_SHAPES:
        p, x = affine_inputs(v, n, seed=v, device=dev)
        d = max_diff(batched_affine(p, x), batched_affine_ref(p, x))
        affine_rows.append({"v": v, "n": n, "max_abs_err": d})
        require(d <= AFFINE_TOL,
                f"batched_affine vs plain version {affine_rows[-1]}")
        affine_err = max(affine_err, d)
    torch.cuda.synchronize()
    emit({"phase": "kernel_vs_plain", "seconds": time.perf_counter() - t0,
          "fused_pd_step": {"tol": STEP_TOL, "max_abs_dw_du": err,
                            "cases": rows},
          "tv_prox": {"tol": 0.0, "max_abs_err": tv_err, "cases": tv_rows},
          "batched_affine": {"tol": AFFINE_TOL, "max_abs_err": affine_err,
                             "cases": affine_rows}})
    return {"fused_pd_step": err, "tv_prox": tv_err,
            "batched_affine": affine_err}


def reset_launches() -> None:
    from repro_torch.kernels.pd_step import fused_pd_step
    from repro_torch.kernels.ridge_prox import batched_affine
    from repro_torch.kernels.tv_prox import tv_prox
    fused_pd_step.launches = tv_prox.launches = batched_affine.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.pd_step import fused_pd_step
    from repro_torch.kernels.ridge_prox import batched_affine
    from repro_torch.kernels.tv_prox import tv_prox
    return {"fused_pd_step": fused_pd_step.launches,
            "tv_prox": tv_prox.launches,
            "batched_affine": batched_affine.launches}


def compare(got, want) -> tuple[float, float]:
    """(max |dw|, max relative objective difference) of two results."""
    dw = max_diff(got.w, want.w)
    obj_rel = float(((got.objective - want.objective).abs()
                     / want.objective.abs()).max())
    return dw, obj_rel


def phase_paper_s5(torch, cfg) -> None:
    """The §5 instance through both kernel paths, each against the
    dense backend on the card."""
    from repro_torch.api import Problem, Solver
    from repro_torch.data.synthetic import make_sbm_regression

    t0 = time.perf_counter()
    ds = make_sbm_regression(seed=0)
    problem = Problem.create(ds.graph, ds.data, 1e-3)
    reset_launches()
    fused = Solver(cfg).run(problem, w_true=ds.w_true)
    torch.cuda.synchronize()
    launches = read_launches()
    reset_launches()
    unfused = Solver(cfg.replace(fused=False)).run(problem, w_true=ds.w_true)
    torch.cuda.synchronize()
    unfused_launches = read_launches()
    dense = Solver(cfg.replace(backend="dense")).run(problem,
                                                     w_true=ds.w_true)
    dw, obj_rel = compare(fused, dense)
    u_dw, u_obj_rel = compare(unfused, dense)
    diag = {k: float(v) for k, v in fused.diagnostics.items()}
    emit({"phase": "paper_s5", "seconds": time.perf_counter() - t0,
          "launches": launches, "max_abs_dw_vs_dense": dw,
          "objective_max_rel_vs_dense": obj_rel,
          "mse_last": float(fused.mse[-1]),
          "dense_mse_last": float(dense.mse[-1]), "diagnostics": diag,
          "unfused": {"launches": unfused_launches,
                      "max_abs_dw_vs_dense": u_dw,
                      "objective_max_rel_vs_dense": u_obj_rel,
                      "mse_last": float(unfused.mse[-1])}})
    require(launches["fused_pd_step"] > 0, "the §5 solve launched no kernel")
    require(dw <= SOLVE_TOL, f"§5 fused vs dense |dw| = {dw}")
    require(obj_rel <= SOLVE_TOL, f"§5 objective rel diff {obj_rel}")
    require(bool(torch.isfinite(fused.w).all()), "§5 w not finite")
    require(diag["dual_infeasibility"] <= 1e-6, "§5 dual infeasible")
    require(unfused_launches["tv_prox"] > 0
            and unfused_launches["batched_affine"] > 0
            and unfused_launches["fused_pd_step"] == 0,
            f"§5 unfused solve launches {unfused_launches}")
    require(u_dw <= SOLVE_TOL, f"§5 unfused vs dense |dw| = {u_dw}")
    require(u_obj_rel <= SOLVE_TOL, f"§5 unfused objective rel {u_obj_rel}")


def phase_zoo(torch, dev) -> None:
    """The eight scenarios at smoke size on the card: the route
    ``fused=None`` takes, and the unfused path against the dense
    backend, with each kernel's launches."""
    from repro_torch.api import Solver, SolverConfig, backends
    from repro_torch.scenarios import SCENARIOS, get_scenario

    t0 = time.perf_counter()
    base = SolverConfig(num_iters=200, rho=1.9)
    rows = []
    for name in sorted(SCENARIOS):
        scenario = get_scenario(name)
        problem = scenario.build(seed=0, smoke=True, device=dev).problem
        auto = base.replace(backend="pallas")
        route = ("fused" if backends._should_fuse(problem, auto)
                 else "unfused")
        dense = Solver(base).run(problem)
        reset_launches()
        unfused = Solver(base.replace(backend="pallas", fused=False)).run(
            problem)
        torch.cuda.synchronize()
        launches = read_launches()
        reset_launches()
        routed = Solver(auto).run(problem)
        torch.cuda.synchronize()
        route_launches = read_launches()
        dw, obj_rel = compare(unfused, dense)
        r_dw, r_obj_rel = compare(routed, dense)
        row = {"scenario": name, "loss": scenario.loss,
               "regularizer": scenario.regularizer, "route": route,
               "unfused_launches": launches,
               "unfused_max_abs_dw_vs_dense": dw,
               "unfused_objective_max_rel_vs_dense": obj_rel,
               "route_launches": route_launches,
               "route_max_abs_dw_vs_dense": r_dw,
               "route_objective_max_rel_vs_dense": r_obj_rel,
               "dual_infeasibility": float(
                   unfused.diagnostics["dual_infeasibility"])}
        rows.append(row)
        require(dw <= SOLVE_TOL and obj_rel <= ZOO_OBJ_RTOL,
                f"zoo unfused vs dense {row}")
        require(r_dw <= SOLVE_TOL and r_obj_rel <= SOLVE_TOL,
                f"zoo fused=None route vs dense {row}")
        require((launches["tv_prox"] > 0) == (scenario.regularizer == "tv"),
                f"zoo tv_prox launches {row}")
        require((launches["batched_affine"] > 0)
                == (scenario.loss == "squared"),
                f"zoo batched_affine launches {row}")
        require((route == "fused") == (route_launches["fused_pd_step"] > 0),
                f"zoo route launches {row}")
        require(bool(torch.isfinite(unfused.w).all()), f"zoo w {row}")
    emit({"phase": "zoo", "seconds": time.perf_counter() - t0,
          "num_iters": base.num_iters, "rho": base.rho,
          "tol_w": SOLVE_TOL, "tol_objective_rel": ZOO_OBJ_RTOL,
          "scenarios": rows})


def phase_full_size(torch, dev, cfg, big, w_true, gen_s) -> dict:
    """The scale-out topology at FULL_NODES through the fused path, then
    the kernel alone and its plain version over one metric block from a
    random state at the solve's scale.  Returns the kernel's entry for
    the kernels' line."""
    from repro_torch.api import Solver, backends
    from repro_torch.engine import capped
    from repro_torch.kernels.pd_step import fused_pd_step
    from repro_torch.kernels.ref import fused_pd_step_ref

    t0 = time.perf_counter()
    require(backends._should_fuse(big, cfg), "full size does not fuse")
    plan_s = time.perf_counter() - t0         # plans and caches the layout
    lt = backends._graph_layout(big.graph)

    iterations = (capped(cfg.warm_iters, cfg.metric_every)
                  + capped(cfg.final_iters, cfg.metric_every))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launches()
    result = Solver(cfg).run(big, w_true=w_true)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = fused_pd_step.launches
    peak = torch.cuda.max_memory_allocated()
    diag = {k: float(v) for k, v in result.diagnostics.items()}
    require(launches > 0, "the full-size solve launched no kernel")
    require(bool(torch.isfinite(result.w).all()
                 and torch.isfinite(result.objective).all()),
            "full-size result not finite")
    require(diag["dual_infeasibility"] <= 1e-6, "full-size dual infeasible")

    # the kernel alone at the target lambda, from a state that still
    # moves: w at the solve's scale (|w_true| = 2), each dual drawn
    # uniformly from its box [-la_e, la_e]
    (params_s, pkeys, _, tau_s, _, sig2, src2, dst2, la2, _) = \
        backends._fused_setup(big.graph, big.data, big.lam, None,
                              loss=big.loss, reg=big.regularizer, layout=lt)
    n, eb, lo = big.num_features, lt.block_edges, lt.klo * lt.block_edges
    gen = torch.Generator(device=dev).manual_seed(1)
    w_store = lt.pad_node_store(2.0 * torch.randn(
        (lt.nodes_pad, n), generator=gen, device=dev))
    u_store = torch.zeros(((lt.num_blocks + lt.klo + lt.khi) * eb, n),
                          device=dev)
    u_store[lo:lo + lt.edges_pad] = la2 * (2.0 * torch.rand(
        (lt.edges_pad, n), generator=gen, device=dev) - 1.0)
    args = (w_store, u_store, lt.pad_node_store(lt.inc_edges),
            lt.pad_node_store(lt.inc_signs), params_s, tau_s, src2, dst2,
            sig2, la2)
    kw = dict(loss=big.loss, reg=big.regularizer, pkeys=pkeys,
              block_nodes=lt.block_nodes, block_edges=eb, kn=lt.kn,
              klo=lt.klo, khi=lt.khi, rho=cfg.rho)
    ms = cuda_ms(lambda _: fused_pd_step(*args, **kw), reps=20)
    plain_ms = cuda_ms(lambda _: fused_pd_step_ref(*args, **kw), reps=3)
    block_iters = cfg.metric_every if lt.num_blocks == 1 else 1
    block_ms = cuda_ms(
        lambda _: fused_pd_step(*args, **kw, iters=block_iters), reps=3)
    cost = step_cost(args, kw)

    def metric_block(fn, args):
        """One metric block (``metric_every`` iterations) from the shared
        state, launched as the solve launches it."""
        if lt.num_blocks == 1:
            return fn(*args, **kw, iters=cfg.metric_every)
        ws, us = args[0].clone(), args[1].clone()
        for _ in range(cfg.metric_every):
            wn, un = fn(ws, us, *args[2:], **kw)
            ws[:wn.shape[0]] = wn
            us[lo:lo + un.shape[0]] = un
        return wn, un

    k_out = metric_block(fused_pd_step, args)
    p_out = metric_block(fused_pd_step_ref, args)
    dw, du = max_diff(k_out[0], p_out[0]), max_diff(k_out[1], p_out[1])
    # how far the plain version moved the state: a wrong kernel is caught
    # only where the state moves well beyond the limit
    moved_w = max_diff(p_out[0], w_store[:p_out[0].shape[0]])
    moved_u = max_diff(p_out[1], u_store[lo:lo + p_out[1].shape[0]])
    # the plain version in float64 as a yardstick: how far each float32
    # version drifts from exact arithmetic over the block
    def f64(t):
        return t.double() if t.is_floating_point() else t
    args64 = tuple(tuple(map(f64, a)) if isinstance(a, tuple) else f64(a)
                   for a in args)
    x_out = metric_block(fused_pd_step_ref, args64)
    drift = {"kernel_dw": max_diff(k_out[0], x_out[0]),
             "kernel_du": max_diff(k_out[1], x_out[1]),
             "plain_dw": max_diff(p_out[0], x_out[0]),
             "plain_du": max_diff(p_out[1], x_out[1])}
    block_cfg = cfg.replace(continuation=False, num_iters=cfg.metric_every,
                            compute_diagnostics=False)
    prof = device_profile(torch, lambda _: Solver(block_cfg).run(big),
                          reps=1)
    emit({"phase": "full_size", "nodes": big.num_nodes,
          "edges": big.graph.num_edges, "max_degree": big.graph.max_degree,
          "layout": {"num_blocks": lt.num_blocks,
                     "block_nodes": lt.block_nodes, "block_edges": eb,
                     "kn": lt.kn, "klo": lt.klo, "khi": lt.khi},
          "generate_seconds": gen_s, "plan_seconds": plan_s,
          "solve_seconds": solve_s, "iterations": iterations,
          "iterations_per_s": iterations / solve_s, "launches": launches,
          "kernel_ms_per_step": ms,
          "kernel_ms_per_launch": {"iters": block_iters, "ms": block_ms},
          "plain_ms_per_step": plain_ms, **cost,
          "max_memory_allocated": peak, "mse_last": float(result.mse[-1]),
          "objective_last": float(result.objective[-1]),
          "diagnostics": diag, "block_iters": cfg.metric_every,
          "block_max_abs_dw": dw, "block_max_abs_du": du,
          "plain_moved_max_abs_w": moved_w,
          "plain_moved_max_abs_u": moved_u, "block_drift_from_f64": drift,
          "profile_one_metric_block": prof})
    require(max(dw, du) <= SOLVE_TOL,
            f"full size, {cfg.metric_every} iterations: |dw| {dw}, "
            f"|du| {du}")
    require(min(moved_w, moved_u) >= 10 * SOLVE_TOL,
            f"full size: the state barely moved (|w| {moved_w}, "
            f"|u| {moved_u}), so the comparison shows nothing")
    return dict(KERNELS["fused_pd_step"], launches=launches,
                max_abs_err=max(dw, du), ms=ms, plain_ms=plain_ms,
                bound_ms=cost["bound_ms"], bound_by=cost["bound_by"],
                library_ms=None)


def phase_unfused_full_size(torch, dev, cfg, big, w_true) -> list:
    """The same instance through the unfused continuation solve and the
    dense one on the card, then each unfused kernel alone at the solve's
    shapes against its plain version and the one PyTorch call that
    computes the same function.  Returns the kernels' entries."""
    from repro_torch.api import Solver
    from repro_torch.engine import capped
    from repro_torch.kernels.ref import batched_affine_ref, tv_prox_ref
    from repro_torch.kernels.ridge_prox import batched_affine
    from repro_torch.kernels.tv_prox import tv_prox

    ucfg = cfg.replace(fused=False)
    iterations = (capped(cfg.warm_iters, cfg.metric_every)
                  + capped(cfg.final_iters, cfg.metric_every))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launches()
    result = Solver(ucfg).run(big, w_true=w_true)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    dense = Solver(cfg.replace(backend="dense")).run(big, w_true=w_true)
    torch.cuda.synchronize()
    dense_s = time.perf_counter() - t0
    dw, obj_rel = compare(result, dense)
    diag = {k: float(v) for k, v in result.diagnostics.items()}
    block_cfg = ucfg.replace(continuation=False, num_iters=cfg.metric_every,
                             compute_diagnostics=False)
    solve_prof = device_profile(torch, lambda _: Solver(block_cfg).run(big),
                                reps=1)
    require(launches["tv_prox"] == iterations
            and launches["batched_affine"] == iterations
            and launches["fused_pd_step"] == 0,
            f"full-size unfused launches {launches}, {iterations} iterations")
    require(bool(torch.isfinite(result.w).all()
                 and torch.isfinite(result.objective).all()),
            "full-size unfused result not finite")
    require(diag["dual_infeasibility"] <= 1e-6,
            "full-size unfused dual infeasible")
    require(dw <= SOLVE_TOL, f"full-size unfused vs dense |dw| = {dw}")

    # each kernel alone at the solve's shapes, from a state that moves:
    # the target lambda's clip levels with u from twice its box, and the
    # solve's own prox matrices with v ~ N(0, 4)
    g = big.graph
    e, n, v_nodes = g.num_edges, big.num_features, big.num_nodes
    bnd = (big.lam * g.weights).contiguous()
    u = box_draw(bnd, n, seed=2)
    tv_err = max_diff(tv_prox(u, bnd), tv_prox_ref(u, bnd))
    clipped = float((u.abs() > bnd[:, None]).float().mean())
    lo, hi = -bnd[:, None], bnd[:, None]
    tv_cost = bound(4 * (u.numel() + bnd.numel()), 4 * u.numel(),
                    2 * u.numel())
    tv_times = {"ms": cuda_ms(lambda _: tv_prox(u, bnd), reps=50),
                "plain_ms": cuda_ms(lambda _: tv_prox_ref(u, bnd), reps=50),
                "library_ms": cuda_ms(lambda _: torch.clamp(u, lo, hi),
                                      reps=50)}

    p = big.loss.prox_setup(big.data, g.primal_stepsizes())["p"]
    p, v = affine_inputs(v_nodes, n, seed=3, device=dev, p=p.contiguous(),
                         v_scale=2.0)
    affine_err = max_diff(batched_affine(p, v), batched_affine_ref(p, v))
    # 32 MB per call fits in the 50 MB L2: rotate over copies whose
    # inputs together exceed it four times, so each call reads from HBM
    per_copy = 4 * (p.numel() + v.numel())
    copies = max(2, int(-(-4 * L2_BYTES // per_copy)))
    ps = [p.clone() for _ in range(copies)]
    vs = [v.clone() for _ in range(copies)]
    affine_cost = bound(per_copy, 4 * v.numel(), 2 * p.numel())
    affine_times = {
        "ms": cuda_ms(lambda i: batched_affine(ps[i], vs[i]), reps=200,
                      copies=copies),
        "plain_ms": cuda_ms(lambda i: batched_affine_ref(ps[i], vs[i]),
                            reps=200, copies=copies),
        "library_ms": cuda_ms(lambda i: torch.bmm(ps[i], vs[i][..., None]),
                              reps=200, copies=copies)}
    tv_prof = device_profile(torch, lambda _: tv_prox(u, bnd), reps=50)
    affine_prof = device_profile(
        torch, lambda i: batched_affine(ps[i % copies], vs[i % copies]),
        reps=200)
    del ps, vs
    emit({"phase": "unfused_full_size", "nodes": v_nodes, "edges": e,
          "solve_seconds": solve_s, "iterations": iterations,
          "iterations_per_s": iterations / solve_s, "launches": launches,
          "max_memory_allocated": peak, "dense_solve_seconds": dense_s,
          "dense_iterations_per_s": iterations / dense_s,
          "max_abs_dw_vs_dense": dw, "objective_max_rel_vs_dense": obj_rel,
          "mse_last": float(result.mse[-1]),
          "dense_mse_last": float(dense.mse[-1]), "diagnostics": diag,
          "profile_one_metric_block": solve_prof,
          "tv_prox": {"shape": [e, n], "max_abs_err": tv_err,
                      "clipped_share": clipped, **tv_times, **tv_cost,
                      "profile": tv_prof},
          "batched_affine": {"shape": [v_nodes, n, n],
                             "max_abs_err": affine_err,
                             "timing_copies": copies,
                             "timing_bytes_in_rotation": copies * per_copy,
                             **affine_times, **affine_cost,
                             "profile": affine_prof}})
    require(tv_err == 0.0, f"full-size tv_prox vs plain |d| = {tv_err}")
    require(0.25 <= clipped <= 0.75,
            f"full-size tv_prox check clipped {clipped} of the entries")
    require(affine_err <= AFFINE_TOL,
            f"full-size batched_affine vs plain |d| = {affine_err}")
    return [dict(KERNELS["tv_prox"], launches=launches["tv_prox"],
                 max_abs_err=tv_err, ms=tv_times["ms"],
                 plain_ms=tv_times["plain_ms"], bound_ms=tv_cost["bound_ms"],
                 bound_by=tv_cost["bound_by"],
                 library_ms=tv_times["library_ms"]),
            dict(KERNELS["batched_affine"],
                 launches=launches["batched_affine"],
                 max_abs_err=affine_err, ms=affine_times["ms"],
                 plain_ms=affine_times["plain_ms"],
                 bound_ms=affine_cost["bound_ms"],
                 bound_by=affine_cost["bound_by"],
                 library_ms=affine_times["library_ms"])]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import Problem, SolverConfig
    from repro_torch.device import resolve_device

    # full float32 everywhere: the plain versions are the yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    cfg = SolverConfig(backend="pallas", continuation=True, rho=1.9,
                       metric_every=100)

    print(card_line(), flush=True)
    phase_build(torch)
    errs = phase_kernel_vs_plain(torch, dev)
    phase_paper_s5(torch, cfg)
    phase_zoo(torch, dev)
    # one full-size instance for both kernel paths
    t0 = time.perf_counter()
    graph, data, w_true = make_clustered(FULL_NODES, seed=0, device=dev)
    gen_s = time.perf_counter() - t0
    big = Problem.create(graph, data, 1e-3)
    kernels = [phase_full_size(torch, dev, cfg, big, w_true, gen_s)]
    kernels += phase_unfused_full_size(torch, dev, cfg, big, w_true)
    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"], errs[k["name"]])
    emit({"kernels": kernels})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, drives the main path — the fused
primal-dual solve ``Solver(SolverConfig(backend="pallas", ...)).run`` —
on the paper's §5 instance and at full size (1,000,000 nodes, ~10.2M
edges), and checks what comes out.  Each phase prints one JSON line with
its seconds; any mismatch or error exits non-zero before the result.
The last three lines are the kernels' line, the card's name and power
limit (``nvidia-smi``), and ``{"ok": true, "device": {...}}``.

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
KERNEL = {"name": "fused_pd_step", "route": "cuda",
          "source": "src/repro_torch/csrc/pd_step.cu",
          "replaces": "src/repro/kernels/pd_step.py:144"}


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


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card (CUDA events,
    after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes_read": read, "bytes_written": written,
            "incidence_bytes_filled": incidence,
            "incidence_bytes_padded": (inc_e.numel() * inc_e.element_size()
                                       + inc_s.numel() * inc_s.element_size()),
            "flops": flops, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def phase_build(torch) -> None:
    from repro_torch.kernels import pd_step as kmod

    t0 = time.perf_counter()
    lib, log = kmod.build(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kind": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc_flags": " ".join(kmod.NVCC_FLAGS),
          "library": str(lib.relative_to(ROOT)),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})


def phase_kernel_vs_plain(torch, dev) -> float:
    """Every kernel option against the plain version; returns the max
    |dw|, |du| seen."""
    from repro_torch.api.losses import SquaredLoss
    from repro_torch.api.regularizers import SquaredTV, TotalVariation
    from repro_torch.kernels.pd_step import fused_pd_step
    from repro_torch.kernels.ref import fused_pd_step_ref

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
    emit({"phase": "kernel_vs_plain", "seconds": time.perf_counter() - t0,
          "tol": STEP_TOL, "max_abs_dw_du": err, "cases": rows})
    return err


def phase_paper_s5(torch, cfg) -> None:
    """The §5 instance through the main path, against the dense
    backend on the card."""
    from repro_torch.api import Problem, Solver
    from repro_torch.data.synthetic import make_sbm_regression
    from repro_torch.kernels.pd_step import fused_pd_step

    t0 = time.perf_counter()
    ds = make_sbm_regression(seed=0)
    problem = Problem.create(ds.graph, ds.data, 1e-3)
    fused_pd_step.launches = 0
    fused = Solver(cfg).run(problem, w_true=ds.w_true)
    torch.cuda.synchronize()
    launches = fused_pd_step.launches
    dense = Solver(cfg.replace(backend="dense")).run(problem,
                                                     w_true=ds.w_true)
    dw = max_diff(fused.w, dense.w)
    obj_rel = float(((fused.objective - dense.objective).abs()
                     / dense.objective.abs()).max())
    diag = {k: float(v) for k, v in fused.diagnostics.items()}
    emit({"phase": "paper_s5", "seconds": time.perf_counter() - t0,
          "launches": launches, "max_abs_dw_vs_dense": dw,
          "objective_max_rel_vs_dense": obj_rel,
          "mse_last": float(fused.mse[-1]),
          "dense_mse_last": float(dense.mse[-1]), "diagnostics": diag})
    require(launches > 0, "the §5 solve launched no kernel")
    require(dw <= SOLVE_TOL, f"§5 fused vs dense |dw| = {dw}")
    require(obj_rel <= SOLVE_TOL, f"§5 objective rel diff {obj_rel}")
    require(bool(torch.isfinite(fused.w).all()), "§5 w not finite")
    require(diag["dual_infeasibility"] <= 1e-6, "§5 dual infeasible")


def phase_full_size(torch, dev, cfg) -> dict:
    """The scale-out topology at FULL_NODES through the main path, then
    the kernel alone and its plain version over one metric block from a
    random state at the solve's scale.  Returns the kernel's entry for
    the kernels' line."""
    from repro_torch.api import Problem, Solver, backends
    from repro_torch.engine import capped
    from repro_torch.kernels.pd_step import fused_pd_step
    from repro_torch.kernels.ref import fused_pd_step_ref

    t0 = time.perf_counter()
    graph, data, w_true = make_clustered(FULL_NODES, seed=0, device=dev)
    gen_s = time.perf_counter() - t0
    big = Problem.create(graph, data, 1e-3)
    t0 = time.perf_counter()
    require(backends._should_fuse(big, cfg), "full size does not fuse")
    plan_s = time.perf_counter() - t0         # plans and caches the layout
    lt = backends._graph_layout(big.graph)

    iterations = (capped(cfg.warm_iters, cfg.metric_every)
                  + capped(cfg.final_iters, cfg.metric_every))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fused_pd_step.launches = 0
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
    ms = cuda_ms(lambda: fused_pd_step(*args, **kw), reps=20)
    plain_ms = cuda_ms(lambda: fused_pd_step_ref(*args, **kw), reps=3)
    block_iters = cfg.metric_every if lt.num_blocks == 1 else 1
    block_ms = cuda_ms(
        lambda: fused_pd_step(*args, **kw, iters=block_iters), reps=3)
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
          "plain_moved_max_abs_u": moved_u, "block_drift_from_f64": drift})
    require(max(dw, du) <= SOLVE_TOL,
            f"full size, {cfg.metric_every} iterations: |dw| {dw}, "
            f"|du| {du}")
    require(min(moved_w, moved_u) >= 10 * SOLVE_TOL,
            f"full size: the state barely moved (|w| {moved_w}, "
            f"|u| {moved_u}), so the comparison shows nothing")
    return dict(KERNEL, launches=launches, max_abs_err=max(dw, du), ms=ms,
                plain_ms=plain_ms, bound_ms=cost["bound_ms"],
                bound_by=cost["bound_by"], library_ms=None)


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
    from repro_torch.api import SolverConfig
    from repro_torch.device import resolve_device

    # full float32 everywhere: the plain versions are the yardstick
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = resolve_device(None)
    cfg = SolverConfig(backend="pallas", continuation=True, rho=1.9,
                       metric_every=100)

    print(card_line(), flush=True)
    phase_build(torch)
    step_err = phase_kernel_vs_plain(torch, dev)
    phase_paper_s5(torch, cfg)
    kernel = phase_full_size(torch, dev, cfg)
    kernel["max_abs_err"] = max(kernel["max_abs_err"], step_err)
    emit({"kernels": [kernel]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

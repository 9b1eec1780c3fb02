#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels (``fused_pd_step`` for the squared, lasso
and logistic losses, at the register tile and wide, staged and streamed;
``tv_prox``, ``batched_affine``; the certificate's ``sym_pinv``) from this
checkout into one library, holds every kernel and variant (each loss in float32
and bfloat16 storage) against its plain PyTorch version on the card
(and ``fused_pd_step`` bit-identical over two launches), and
drives both kernel paths of ``Solver(SolverConfig(backend="pallas",
...)).run``: the fused primal-dual solve and the unfused one (the dense
loop with ``tv_prox`` and ``batched_affine`` wired in).  They run on the
paper's §5 instance, the eight scenarios of the zoo (every loss fused,
and in bf16 storage), a ``tol`` phase that stops on the device with one
fetch under ``torch.cuda.set_sync_debug_mode("error")``, and at full size
(1,000,000 nodes, ~10.2M edges, one graph shared by every solve): the
fused squared solve in float32 and bfloat16, the logistic and lasso
solves in both, a fused tol solve, and the unfused and dense solves, each
checked against the dense backend or the plain version on the card.
Then, on the same graph, the lane (batch) axis every kernel takes in one
launch: ``solve_path`` over six lambdas through the fused lanes (each
lane against a one-lane solve, bit for bit, and the squared f32 sweep
against the dense path's), the masked tol sweep through the unfused
lanes under sync debug mode "error", and ``solve_many`` of four problems
on two graph structures; each lane kernel against its plain version and
against one-lane launches.  The fused kernel past its register tile
(``wide_vs_plain``: the wide variant, a node a warp, for every loss and
storage type at n = 17-128, and the streamed variants past the staging
plan, against the plain version, over lanes, the wide one bit-identical
to the staged variant and the register tile's logistic one within
STEP_TOL of it; ``wide_features``: n = 17 and 33 through the fused
route, a tol solve captured under the IF node).
Then the two lambda paths that once raised (``lane_faults``: a logistic
path past the kernel's staging plan runs the fused lanes streamed, each
lane within SOLVE_TOL of a one-lane solve and six streamed lanes the
bits of six one-lane streamed launches; 4097 lambdas launch in lane
groups, bit-identical to one-lane solves), the federated runtime in synchronous
mode against the dense backend on §5 and the zoo (``federated_s5``) and
at full size with partial participation, int8 messages, its ledger and a
checkpointed resume (``federated_full_size``), and telemetry at full size
(``obs_full_size``: the fused solve with telemetry off and on, and a
traced dense block's device time by Algorithm 1 phase).  Then the tol
engines that stop computing at the stop (``tol_engine``: each engine's
CUDA graph under an IF node against its plain loop, bit for bit, on §5
and at full size; a dense full-size tol solve at budget B and 4B) and
the solve service (``serving_s5``: dense and fused services on §5 and
the serving tests' chains, each answer equal to ``Solver.run`` from the
same state, and the certificate's ``sym_pinv`` kernel against its
plain version and ``torch.linalg.pinv`` at n = 2-64; ``serving_full_size``:
cold and warm requests at 1M, a second tenant's plan hit, plans saved
and loaded into a restarted service that plans nothing, ``solve_batch``
of four sessions, a dense pair).  Last, the slice past the register tile
at full size: ``wide_full_size`` (every loss at n = 32 on the 1M graph in
float32 and bfloat16, against the dense backend, and a 6-lambda path
through the wide lanes), ``wide_streamed`` (wide nodes past the staging
plan, 2,000 nodes) and ``many_samples_full_size`` (logistic nodes of
16,384 samples on 20,000 nodes, streamed, in float32 and bfloat16 and
over a 6-lambda path, against the dense backend; the kernel alone at
the instance's 10% labeled nodes and with every node labeled).
Then the sharded backends (``sharded``: the halo-exchange engine step;
``sharded_fused``: ``fused_pd_step`` on each shard's own layout with a
dual halo refresh between shards): ``sharded_s5`` (§5 and the zoo on a
one-rank mesh against the dense backend; the kernel against its plain
version on each of four shards' layouts), ``sharded_full_size`` (a
250,000-node clustered graph through both in an NCCL world of one
rank) and
``sharded_ranks`` (worlds of 2 and 4 processes on the one card over
gloo, the exchange through the host, on a 100,000-node graph; each
rank's kernel runs counted by the kernel).
Where a tol engine replays a captured block, the kernels it ran are
counted on the card by the kernels themselves (``device_executions``):
the wrappers' launch counters count only the launches made outside a
capture.
Each phase prints one JSON line with its seconds; any mismatch or error
exits non-zero before the result.  The last three lines are the kernels'
line, the card's name and power limit (``nvidia-smi``), and ``{"ok":
true, "device": {...}}``.

``python3 chip_smoke.py --ab PARENT`` compares the checkout ``PARENT``
with this one instead (``ab_main``).

Needs one CUDA device and the CUDA toolkit (``nvcc``); exits non-zero
without printing a result when there is no card, or when it is run
outside a checkout of the repository.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
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
# fused_pd_step's variants: (loss, storage) -> kernels' line name; the
# squared float32 one keeps the plain name of the earlier slices
LOSS_SOURCE = {"squared": "src/repro_torch/csrc/pd_step.cu",
               "lasso": "src/repro_torch/csrc/pd_step_lasso.cu",
               "logistic": "src/repro_torch/csrc/pd_step_logistic.cu"}
VARIANTS = [(loss, dt) for loss in ("squared", "lasso", "logistic")
            for dt in ("float32", "bfloat16")]


def variant_name(loss: str, dtype: str) -> str:
    if (loss, dtype) == ("squared", "float32"):
        return "fused_pd_step"
    return f"fused_pd_step[{loss},{'f32' if dtype == 'float32' else 'bf16'}]"


for _loss, _dt in VARIANTS:
    KERNELS.setdefault(variant_name(_loss, _dt), {
        "name": variant_name(_loss, _dt), "route": "cuda",
        "source": LOSS_SOURCE[_loss],
        "replaces": "src/repro/kernels/pd_step.py:144"})
# the lane variants (a lambda path or a batch of problems, one launch for
# every lane): kernels' line name -> (source, TPU kernel)
LANE_KERNELS = {
    "fused_pd_step[lanes]": "squared/float32",
    "fused_pd_step[bf16,lanes]": "squared/bfloat16",
    "fused_pd_step[lasso,f32,lanes]": "lasso/float32",
    "fused_pd_step[logistic,f32,lanes]": "logistic/float32"}
for _name, _variant in LANE_KERNELS.items():
    KERNELS[_name] = {"name": _name, "route": "cuda",
                      "source": LOSS_SOURCE[_variant.split("/")[0]],
                      "replaces": "src/repro/kernels/pd_step.py:144"}
# the wide (n > 16) and streamed (parameters read from device memory)
# variants the main path runs: kernels' line name -> the launch counters'
# key (kernels/pd_step.py:variant_key) and source
WIDE_SOURCE = {
    ("squared", "f32"): "src/repro_torch/csrc/pd_step_wide.cu",
    ("squared", "bf16"): "src/repro_torch/csrc/pd_step_wide.cu",
    ("lasso", "f32"): "src/repro_torch/csrc/pd_step_wide_lasso.cu",
    ("lasso", "bf16"): "src/repro_torch/csrc/pd_step_wide_lasso.cu",
    ("logistic", "f32"): "src/repro_torch/csrc/pd_step_wide_logistic.cu",
    ("logistic", "bf16"):
        "src/repro_torch/csrc/pd_step_wide_logistic_bf16.cu"}
STREAMED_SOURCE = "src/repro_torch/csrc/pd_step_logistic_streamed.cu"
NEW_VARIANTS = {
    **{f"fused_pd_step[{loss},{tag},wide]": (f"{loss}/{dt}/wide",
                                             WIDE_SOURCE[loss, tag])
       for loss in ("squared", "lasso", "logistic")
       for dt, tag in (("float32", "f32"), ("bfloat16", "bf16"))},
    "fused_pd_step[squared,f32,wide,lanes]": (
        "squared/float32/wide", WIDE_SOURCE["squared", "f32"]),
    **{f"fused_pd_step[{loss},f32,wide,streamed]": (
        f"{loss}/float32/wide/streamed", WIDE_SOURCE[loss, "f32"])
       for loss in ("squared", "lasso", "logistic")},
    "fused_pd_step[logistic,f32,streamed]": ("logistic/float32/streamed",
                                             STREAMED_SOURCE),
    "fused_pd_step[logistic,bf16,streamed]": ("logistic/bfloat16/streamed",
                                              STREAMED_SOURCE),
    "fused_pd_step[logistic,f32,streamed,lanes]": (
        "logistic/float32/streamed", STREAMED_SOURCE),
}
for _name, (_key, _src) in NEW_VARIANTS.items():
    KERNELS[_name] = {"name": _name, "route": "cuda", "source": _src,
                      "replaces": "src/repro/kernels/pd_step.py:144"}
# a repair, no port: the reference's certificate calls jnp.linalg.pinv
KERNELS["sym_pinv"] = {"name": "sym_pinv", "route": "cuda",
                       "source": "src/repro_torch/csrc/sym_pinv.cu",
                       "replaces": "src/repro/engine/step.py:203"}
KERNELS["tv_prox[lanes]"] = dict(KERNELS["tv_prox"], name="tv_prox[lanes]")
for _kind in ("shared P", "per-lane P"):
    _name = f"batched_affine[lanes,{_kind}]"
    KERNELS[_name] = dict(KERNELS["batched_affine"], name=_name)
# fused_pd_step launched inside each shard of sharded_fused (the squared
# float32 variant on a shard's own layout)
KERNELS["fused_pd_step[sharded]"] = dict(KERNELS["fused_pd_step"],
                                         name="fused_pd_step[sharded]")
# benchmarks/scaling.py:PATH_LAMS: the lambda path of the path phases
PATH_LAMS = np.geomspace(1e-1, 1e-3, 6).astype(np.float32)
PATH_TOL = 1e-6            # a lane against its one-lane fused solve
LASSO_KW = {"alpha": 0.02, "num_inner": 30}    # the zoo's sparse_lasso
AFFINE_TOL = 1e-5          # batched_affine vs plain version (summation order)
ZOO_OBJ_RTOL = 1e-5        # unfused vs dense objective traces, zoo
L2_BYTES = 50e6            # H100 L2 cache
# the wide variant's checked widths: 32 / 33 where its prox rows leave
# registers; for the squared and lasso losses also LAST_STAGED and one
# more, the last width whose staged rows fit a block and the first that
# streams
WIDE_NS = (17, 24, 32, 33, 64, 128)
LAST_STAGED = 239
WIDE_N = 32                # the wide variant's full-size width
MANY_SAMPLES = 16_384      # logistic samples a node past the staging plan
MANY_NODES = 20_000
MANY_ITERS = 20            # their solves' depth (the dense one: ~0.6 s a step)
ROUTE_ITERS = 5            # fused against unfused route: a solve's depth
# the §5 shapes of the port's kernel tests (tests/test_torch_kernels.py)
SHARDED_NODES = 250_000    # sharded_full_size: its graph (see the phase)
SHARDED_ITERS = 1000       # and each sharded solve's depth
RANK_NODES = 100_000       # sharded_ranks: the graph every rank solves
RANK_ITERS = 300
RANK_WORLDS = (2, 4)       # gloo worlds of processes on the one card
RANK_TOL = 2e-4            # sharded vs dense in a world (the reference's)
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


def cuda_ms(fn, reps: int, copies: int = 1, budget_ms: float = 2000.0
            ) -> float:
    """Mean milliseconds per call of ``fn(i)`` on the card (CUDA events,
    after one warm-up call of each input copy, itself timed); call ``r``
    gets copy ``r % copies``, so inputs smaller than L2 can be timed cold.
    A call that takes long runs fewer times, within ``budget_ms`` (at
    least twice)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(copies):
        fn(i)
    end.record()
    end.synchronize()
    first = start.elapsed_time(end) / copies
    reps = max(2, min(reps, int(budget_ms / max(first, 1e-3))))
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


def max_diff(a, b, chunk: int = 1 << 26) -> float:
    """max |a - b| in float64, a slice of ``chunk`` elements at a time
    (six lanes of duals at n = 32 on the full-size graph are 2 G
    elements)."""
    a, b = a.reshape(-1), b.reshape(-1)
    if a.numel() == 0:
        return 0.0
    return max(float((a[i:i + chunk].double() - b[i:i + chunk].double())
                     .abs().max()) for i in range(0, a.numel(), chunk))


def bf16_ulp(scale: float) -> float:
    """One bfloat16 ulp (8 significant bits) at magnitude ``scale``."""
    return float(2.0 ** (np.floor(np.log2(scale)) - 7))


def port_loss(name: str):
    from repro_torch.api.losses import get_loss
    return get_loss(name, **(LASSO_KW if name == "lasso" else {}))


def plain_step(*args, incidence, **kw):
    """The plain version on the arguments of ``kernels.ops.pd_step``: it
    reads the padded tables (``args[2:4]``), not the compact incidence
    the kernel reads."""
    from repro_torch.kernels.ref import fused_pd_step_ref
    return fused_pd_step_ref(*args, **kw)


def forced_streamed(kernel, args, kw):
    """The kernel wrapper on ``kernels.ops.pd_step``'s arguments (it
    takes the compact incidence in ``kw`` and no padded tables,
    ``args[2:4]``), its streamed variant forced."""
    return kernel(*args[:2], *args[4:], **kw, streamed=True)


def step_inputs(v, n, bv, seed, device, loss="squared", dtype="float32",
                samples=None, ridge=False):
    """Storage tensors of one fused step on a small SBM (the shapes of
    the port's kernel tests), with the prox parameters of ``loss`` drawn
    as ``tests/test_torch_kernels.py:_loss_arrays`` draws them (squared:
    P = I + N(0, 0.01), b ~ N(0, 0.01); lasso: 3 samples per node;
    logistic: 8, Bernoulli labels, every third node's last sample
    masked; half the nodes labeled; ``samples`` overrides the count;
    ``ridge``: the squared loss's P a ridge prox's, (I + X^T X / m)^-1 of
    m = n + 1 samples, symmetric with eigenvalues in (0, 1], so a long
    run stays bounded), and w, u and the parameters in the storage
    ``dtype``.  Returns ``kernels.ops.pd_step``'s arguments: the
    padded tables for the plain version, the compact incidence (in
    ``kw``) for the kernel."""
    import torch
    from repro_torch.core.graph import plan_edge_blocks, sbm_graph

    rng = np.random.default_rng(seed)
    g, _ = sbm_graph(rng, (v // 2, v - v // 2), 0.3, 0.03, device=device)
    lt = plan_edge_blocks(g, block_nodes=bv)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    def rand(*shape, scale=1.0):
        return t(scale * rng.standard_normal(shape))

    eb, nodes = lt.block_edges, lt.nodes_pad
    deg = (lt.inc_signs != 0).sum(1).float()
    tau = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                      torch.ones_like(deg))
    u_store = torch.zeros(((lt.num_blocks + lt.klo + lt.khi) * eb, n),
                          device=device)
    u_store[lt.klo * eb:lt.klo * eb + lt.edges_pad] = rand(
        lt.edges_pad, n, scale=0.1)
    w_store = lt.pad_node_store(rand(nodes, n))
    if loss == "squared" and ridge:
        x = rng.standard_normal((nodes, n + 1, n))
        params = (rand(nodes, n, scale=0.1), t(np.linalg.inv(
            np.eye(n) + np.einsum("vmn,vmk->vnk", x, x) / (n + 1))))
    elif loss == "squared":
        params = (rand(nodes, n, scale=0.1),
                  rand(nodes, n, n, scale=0.1) + torch.eye(n, device=device))
    else:
        tau_np = tau.cpu().numpy().astype(np.float64)
        ms = samples or (3 if loss == "lasso" else 8)
        x = rng.standard_normal((nodes, ms, n))
        mask = np.ones((nodes, ms))
        labeled = (rng.random(nodes) < 0.5).astype(np.float64)
        if loss == "lasso":
            y = np.einsum("vmn,vn->vm", x, rng.standard_normal((nodes, n)))
            q = np.einsum("vmn,vmk->vnk", x, x)
            lips = 2.0 * np.linalg.eigvalsh(q)[:, -1] / ms + 1.0 / tau_np
            leaves = (labeled[:, None], np.full((nodes, 1), ms), q,
                      (1.0 / lips)[:, None], tau_np[:, None],
                      np.einsum("vmn,vm->vn", x, y))
        else:
            mask[::3, -1] = 0.0
            y = (rng.random((nodes, ms)) < 0.5) * mask
            leaves = (labeled[:, None], mask.sum(1)[:, None], mask,
                      tau_np[:, None], x, y)
        params = tuple(map(t, leaves))
    store = getattr(torch, dtype)
    args = (w_store.to(store), u_store.to(store),
            lt.pad_node_store(lt.inc_edges), lt.pad_node_store(lt.inc_signs),
            tuple(lt.pad_node_store(a).to(store).contiguous()
                  for a in params),
            lt.pad_node_store(tau[:, None]), lt.src[:, None],
            lt.dst[:, None], torch.full((lt.edges_pad, 1), 0.5,
                                        device=device),
            (0.1 * lt.weights)[:, None])
    pkeys = {"squared": ("b", "p"),
             "lasso": ("labeled", "m", "q", "step", "tau", "xty"),
             "logistic": ("labeled", "m", "mask", "tau", "x", "y")}[loss]
    kw = dict(pkeys=pkeys, block_nodes=lt.block_nodes, block_edges=eb,
              kn=lt.kn, klo=lt.klo, khi=lt.khi, incidence=lt.compact)
    return args, kw


def make_clustered(v: int, seed: int, device):
    """The repo's scale-out topology (``benchmarks/scaling.py:
    _make_clustered``): an SBM with ~2000-node clusters, degree ~20.5,
    0.007*V expected cross edges; n = 2, m_i = 5, 10% of nodes labeled,
    noiseless labels from a per-cluster (2,2) / (-2,2) ground truth.
    Returns the graph, the data, w_true and the cluster of each node."""
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
    return g, data, torch.from_numpy(w_true).to(device), assign


def loss_instances(graph, assign, seed: int):
    """The other two losses on the same graph, at the zoo's widths:
    logistic with 8 samples per node and Bernoulli labels drawn by
    ``data/synthetic.py:make_classification_data`` from the per-cluster
    (2,2) / (-2,2) weights; the lasso at n = 4 with 3 samples per node
    (the m_i < n regime) from ``scenarios/zoo.py:sparse_lasso``'s sparse
    per-cluster weights and noise.  10% of nodes labeled in each.
    Returns {loss: (Problem, w_true)}."""
    from repro_torch.api import Problem
    from repro_torch.data.synthetic import (make_classification_data,
                                            make_regression_data)

    v = graph.num_nodes
    rng = np.random.default_rng(seed)
    cls = make_classification_data(
        rng, graph, np.where(assign[:, None] % 2 == 0, [2.0, 2.0],
                             [-2.0, 2.0]), samples_per_node=8,
        num_labeled=v // 10)
    levels = np.array([[2.0, 0.0, -1.5, 0.0], [0.0, -2.0, 0.0, 1.5]],
                      np.float32)
    reg = make_regression_data(rng, graph, levels[assign % 2],
                               samples_per_node=3, num_labeled=v // 10,
                               noise_scale=0.05)
    dev = graph.device
    return {"logistic": (Problem.create(graph, cls.data, 1e-3,
                                        loss="logistic", device=dev),
                         cls.w_true),
            "lasso": (Problem.create(graph, reg.data, 1e-2, loss="lasso",
                                     device=dev, **LASSO_KW), reg.w_true)}


def bound(read: int, written: int, flops: int) -> dict:
    """The least time on an H100 for a function that must move these
    bytes and do these float operations."""
    t_bytes = (read + written) / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes_read": read, "bytes_written": written, "flops": flops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def prox_flops(loss, n: int, params) -> int:
    """Float operations of one node's prox, as the loss's plain version
    states it."""
    if loss.name == "squared":                  # P (v + b)
        return 2 * n * n + n
    if loss.name == "lasso":                    # ISTA: Q z, gradient, S
        return loss.num_inner * (2 * n * n + 10 * n)
    ms = params[4].shape[1]                     # Newton over m samples
    per_sample = 2 * n + 8 + 2 * n + 3 * n * (n + 1) // 2
    solve = n ** 3 // 3 + 2 * n * n + 3 * n * (n + 1) // 2 + 4 * n
    return loss.num_inner * (ms * per_sample + solve)


def step_cost(args, kw, loss) -> dict:
    """The least time one ``iters=1`` call could take on an H100: bytes
    it must move (each input read once, each output written once) over
    the memory rate, against the float operations this data needs over
    the f32 rate.  The incidence counts as the compact form the kernel
    reads (``kw["incidence"]``: an int32 per in-edge, a (first, count)
    run and a row offset per node).  The lasso's and logistic's prox of
    an unlabeled node returns v whatever its parameters hold, so their
    prox parameter rows and prox flops count for labeled nodes only (the
    ``labeled`` column for every node); ``bound_ms_all_nodes`` is the
    bound with every node's, as the earlier slices counted it.  Beside
    them: the CSR count of the earlier slices (an int32 id and an f32
    sign per filled slot plus row offsets) and the bound with that
    count, and the padded tables."""
    w_store, u_store, inc_e, inc_s, params, tau, src, dst, sg, la = args
    nb = src.shape[0] // kw["block_edges"]
    n = w_store.shape[-1]
    # lane-stacked stores (a lambda path): w, u and la count once per
    # lane (their numel), the shared tables once, outputs and work per lane
    lanes = w_store.shape[0] if w_store.ndim == 3 else 1
    nodes, edges = nb * kw["block_nodes"], nb * kw["block_edges"]
    filled = int((inc_s != 0).sum())
    compact = sum(t.numel() * t.element_size() for t in kw["incidence"])
    csr = 8 * filled + 4 * (inc_s.shape[0] + 1)
    state = sum(t.numel() * t.element_size() for t in
                (w_store, u_store, tau, src, dst, sg, la))
    prm_all = sum(t.numel() * t.element_size() for t in params)
    prox_nodes, prm = nodes, prm_all
    if loss.name in ("lasso", "logistic"):      # params[0]: "labeled"
        prox_nodes = int((params[0] > 0).sum())
        prm = params[0].numel() * params[0].element_size() + sum(
            t[0].numel() * t.element_size() for t in params[1:]) * prox_nodes
    written = lanes * w_store.element_size() * n * (nodes + edges)

    def flops(prox_count):
        return lanes * (2 * filled * n          # signed gather-sum D^T u
                        + nodes * 6 * n
                        + prox_count * prox_flops(loss, n, params)
                        + edges * 9 * n)        # D z, resolvent, KM
    return {**bound(compact + state + prm, written, flops(prox_nodes)),
            "prox_nodes": prox_nodes,
            "bound_ms_all_nodes": bound(compact + state + prm_all, written,
                                        flops(nodes))["bound_ms"],
            "incidence_bytes_compact": compact,
            "incidence_bytes_csr": csr,
            "bound_ms_csr": bound(csr + state + prm, written,
                                  flops(prox_nodes))["bound_ms"],
            "incidence_bytes_padded": (inc_e.numel() * inc_e.element_size()
                                       + inc_s.numel() * inc_s.element_size())}


def phase_build(torch) -> None:
    """All kernel sources into one library, with ``-Xptxas -v`` (the
    kernels, and ``graph_cond.cu``, the tol engines' IF node)."""
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
    require(sorted(logs) == ["graph_cond.cu", "pd_step.cu",
                             "pd_step_lasso.cu", "pd_step_logistic.cu",
                             "pd_step_logistic_streamed.cu",
                             "pd_step_wide.cu", "pd_step_wide_lasso.cu",
                             "pd_step_wide_logistic.cu",
                             "pd_step_wide_logistic_bf16.cu",
                             "ridge_prox.cu", "sym_pinv.cu", "tv_prox.cu"],
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


def f64_args(args):
    """A step's arguments with every float tensor in float64: the plain
    version on them is the yardstick of float32 rounding."""
    def f64(t):
        return t.double() if t.is_floating_point() else t
    return tuple(tuple(map(f64, a)) if isinstance(a, tuple) else f64(a)
                 for a in args)


def check_step(torch, got, want, args, dtype: str,
               step_tol: float = STEP_TOL, exact=None) -> dict:
    """A fused step's outputs against its plain version's: the largest
    |dw|, |du| and residual difference, and the limits they are held to.
    float32: STEP_TOL (the kernel sums in slot order with fused
    multiply-adds and its own expf / sqrtf; the residual, a max of ratios
    of order 1-10, to the same digits relative to its size).  bfloat16:
    both round the same f32 values to nearest even, so an output may
    differ by one bf16 ulp at the state's scale where an f32 difference
    straddles a rounding boundary, and the residual by that ulp over
    min(tau, sigma).  ``exact`` (the plain version in float64): a float32
    limit grows to twice the plain version's own distance from it where
    that is larger (the wide logistic's 128 x 128 Newton solves reach
    ~1e-5 by themselves)."""
    dw, du = max_diff(got[0], want[0]), max_diff(got[1], want[1])
    dr = max_diff(got[2], want[2])
    r_lim = step_tol * max(1.0, float(want[2].abs()))
    lim_w = lim_u = step_tol
    if exact is not None and dtype == "float32":
        lim_w = max(lim_w, 2.0 * max_diff(want[0], exact[0]))
        lim_u = max(lim_u, 2.0 * max_diff(want[1], exact[1]))
        r_lim = max(r_lim, 2.0 * max_diff(want[2], exact[2]))
    if dtype == "bfloat16":
        lim_w = bf16_ulp(float(want[0].float().abs().max()))
        lim_u = bf16_ulp(float(want[1].float().abs().max()))
        tau, sigma = args[5], args[8]
        steps = min(float(tau[tau > 0].min()), float(sigma.min()))
        r_lim += max(lim_w, lim_u) / steps
    return {"dw": dw, "du": du, "dres": dr, "limit_w": lim_w,
            "limit_u": lim_u, "res_limit": r_lim,
            "ok": dw <= lim_w and du <= lim_u and dr <= r_lim}


def kernel_cases() -> list:
    """``kernel_vs_plain``'s cases of the register-tile kernel: the
    earlier slices' squared float32 ones, then every variant at widths
    2..16, nb > 1 and iters > 1, each with the residual: (loss, dtype, v,
    n, bv, rho, reg, iters)."""
    regs = ("tv", "tv2")
    cases = [("squared", "float32", v, n, bv, rho, reg, 1)
             for v, n, bv in ((61, 2, 16), (103, 3, 32), (40, 4, 64))
             for rho in (1.0, 1.9) for reg in regs]
    cases += [("squared", "float32", 48, 2, None, 1.9, reg, 5)
              for reg in regs]
    cases += [(loss, dt) + c for loss, dt in VARIANTS for c in (
        (61, 2, 16, 1.0, "tv", 1), (103, 3, 32, 1.9, "tv2", 1),
        (64, 8, 16, 1.9, "tv", 1), (50, 16, 32, 1.0, "tv2", 1),
        (48, 2, None, 1.9, "tv", 5), (48, 16, None, 1.9, "tv2", 5))]
    return cases


def kernel_digests(torch, device) -> dict:
    """A SHA-256 of the kernel's outputs (w, u, residual) on each of
    ``kernel_cases``' inputs, one lane and three (``lane_args``), with
    the checkout's own ``ops.pd_step``: the A/B run compares them across
    checkouts (the register-tile variants must not change their bits)."""
    import hashlib

    from repro_torch.api.regularizers import SquaredTV, TotalVariation
    from repro_torch.kernels import ops

    regs = {"tv": TotalVariation(), "tv2": SquaredTV()}
    out = {}
    for loss, dt, v, n, bv, rho, reg, iters in kernel_cases():
        args, kw = step_inputs(v, n, bv, seed=v, device=device, loss=loss,
                               dtype=dt)
        kw.update(loss=port_loss(loss), reg=regs[reg], rho=rho, iters=iters,
                  compute_residual=True)
        h = hashlib.sha256()
        for a in (args, lane_args(torch, args, 3)):
            for t in ops.pd_step(*a, **kw):
                h.update(t.detach().float().cpu().numpy().tobytes())
        out[f"{loss}/{dt}/v{v}/n{n}/bv{bv}/rho{rho}/{reg}/i{iters}"] = \
            h.hexdigest()
    return out


def phase_kernel_vs_plain(torch, dev) -> dict:
    """Every kernel option and variant against the plain version, and
    ``fused_pd_step`` launched twice on the same inputs (bit-identical
    outputs: no float atomics in its sums); returns the max error seen
    per kernels' line name."""
    from repro_torch.api.regularizers import SquaredTV, TotalVariation
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import batched_affine_ref, tv_prox_ref
    from repro_torch.kernels.ridge_prox import batched_affine
    from repro_torch.kernels.tv_prox import tv_prox

    t0 = time.perf_counter()
    regs = {"tv": TotalVariation(), "tv2": SquaredTV()}
    rows, errs = [], {variant_name(*vt): 0.0 for vt in VARIANTS}
    for loss, dt, v, n, bv, rho, reg, iters in kernel_cases():
        args, kw = step_inputs(v, n, bv, seed=v, device=dev, loss=loss,
                               dtype=dt)
        kw.update(loss=port_loss(loss), reg=regs[reg], rho=rho, iters=iters,
                  compute_residual=True)
        got = ops.pd_step(*args, **kw)        # the kernel: CUDA tensors
        again = ops.pd_step(*args, **kw)
        want = plain_step(*args, **kw)
        torch.cuda.synchronize()
        row = {"loss": loss, "dtype": dt, "v": v, "n": n, "bv": bv,
               "rho": rho, "reg": reg, "iters": iters,
               "bit_identical_relaunch": all(
                   torch.equal(a, b) for a, b in zip(got, again)),
               **check_step(torch, got, want, args, dt)}
        rows.append(row)
        require(row["ok"], f"kernel vs plain version {row}")
        require(row["bit_identical_relaunch"],
                f"two launches on the same inputs differ {row}")
        name = variant_name(loss, dt)
        errs[name] = max(errs[name], row["dw"], row["du"])

    tv_rows, tv_err = [], 0.0
    for dt in ("float32", "bfloat16"):
        for e, n in TV_SHAPES:
            gen = torch.Generator(device=dev).manual_seed(e)
            level = torch.randn(e, generator=gen, device=dev).abs()
            u = box_draw(level, n, seed=e).to(getattr(torch, dt))
            got, want = tv_prox(u, level), tv_prox_ref(u, level)
            d = max_diff(got, want)
            clipped = float((u.float().abs() > level[:, None]).float().mean())
            tv_rows.append({"dtype": dt, "e": e, "n": n, "max_abs_err": d,
                            "clipped_share": clipped})
            require(d == 0.0 and got.dtype == u.dtype,
                    f"tv_prox vs plain version {tv_rows[-1]}")
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
          "fused_pd_step": {"tol_f32": STEP_TOL,
                            "tol_bf16": "one bf16 ulp at the state's scale",
                            "max_abs_dw_du": errs, "cases": rows},
          "tv_prox": {"tol": 0.0, "max_abs_err": tv_err, "cases": tv_rows},
          "batched_affine": {"tol": AFFINE_TOL, "max_abs_err": affine_err,
                             "cases": affine_rows}})
    return {**errs, "tv_prox": tv_err, "batched_affine": affine_err}


def reset_launches() -> None:
    from repro_torch.kernels.pd_step import fused_pd_step
    from repro_torch.kernels.ridge_prox import batched_affine
    from repro_torch.kernels.sym_pinv import sym_pinv
    from repro_torch.kernels.tv_prox import tv_prox
    fused_pd_step.launches = tv_prox.launches = batched_affine.launches = 0
    sym_pinv.launches = 0
    fused_pd_step.variant_launches.clear()
    for fn in (fused_pd_step, tv_prox, batched_affine):
        fn.lane_launches.clear()


def read_launches() -> dict:
    """Launches per kernel since the last reset, and fused_pd_step's by
    variant ("<loss>/<dtype>"); the launches over more than one lane by
    variant (fused_pd_step), u's dtype (tv_prox) or P's kind
    (batched_affine); and the certificate's sym_pinv."""
    from repro_torch.kernels.pd_step import fused_pd_step
    from repro_torch.kernels.ridge_prox import batched_affine
    from repro_torch.kernels.sym_pinv import sym_pinv
    from repro_torch.kernels.tv_prox import tv_prox
    return {"fused_pd_step": fused_pd_step.launches,
            "tv_prox": tv_prox.launches,
            "batched_affine": batched_affine.launches,
            "sym_pinv": sym_pinv.launches,
            "fused_pd_step_variants": dict(fused_pd_step.variant_launches),
            "lanes": {"fused_pd_step": dict(fused_pd_step.lane_launches),
                      "tv_prox": dict(tv_prox.lane_launches),
                      "batched_affine": dict(batched_affine.lane_launches)}}


#: the kernels whose runs on the card ``device_executions`` reads
EXECUTED = ("fused_pd_step", "tv_prox", "batched_affine")


@contextlib.contextmanager
def device_executions(torch, into: dict):
    """Count, per kernel, the times the card ran it inside the block,
    into ``into``: each kernel adds one to its own device counter on
    every run (``kernels/_build.py:executions``), so the count holds the
    wrappers' launches and the kernels that replays of a tol engine's
    captured block ran (the wrappers count only the former: a replay
    launches the graph, not the kernel).  Zeroed before the block and
    read after it, both outside it."""
    from repro_torch.kernels import _build

    torch.cuda.synchronize()
    _build.reset_executions()
    yield
    torch.cuda.synchronize()
    into.update({k: _build.executions(k) for k in EXECUTED})


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
    ``fused=None`` takes (fused, for every loss), that route and the
    unfused path against the dense backend, each kernel's launches, and
    the fused solve in bf16 storage against the dense f32 one under the
    reference's gates (``tests/test_precision.py``: final objective
    within 15%, w within 0.5 of its scale)."""
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
        reset_launches()
        bf16 = Solver(auto.replace(fused=True, dtype="bfloat16",
                                   metric_every=10)).run(problem)
        torch.cuda.synchronize()
        bf16_launches = read_launches()
        dw, obj_rel = compare(unfused, dense)
        r_dw, r_obj_rel = compare(routed, dense)
        b_obj_rel = float((bf16.objective[-1] - dense.objective[-1])
                          / dense.objective[-1].abs())
        b_w_rel = max_diff(bf16.w, dense.w) / float(dense.w.abs().max())
        row = {"scenario": name, "loss": scenario.loss,
               "regularizer": scenario.regularizer, "route": route,
               "unfused_launches": launches,
               "unfused_max_abs_dw_vs_dense": dw,
               "unfused_objective_max_rel_vs_dense": obj_rel,
               "route_launches": route_launches,
               "route_max_abs_dw_vs_dense": r_dw,
               "route_objective_max_rel_vs_dense": r_obj_rel,
               "bf16_launches": bf16_launches,
               "bf16_objective_rel_vs_dense_f32": b_obj_rel,
               "bf16_w_rel_vs_dense_f32": b_w_rel,
               "dual_infeasibility": float(
                   unfused.diagnostics["dual_infeasibility"])}
        rows.append(row)
        require(dw <= SOLVE_TOL and obj_rel <= ZOO_OBJ_RTOL,
                f"zoo unfused vs dense {row}")
        require(route == "fused", f"zoo: fused=None did not fuse {row}")
        require(r_dw <= SOLVE_TOL and r_obj_rel <= SOLVE_TOL,
                f"zoo fused=None route vs dense {row}")
        require((launches["tv_prox"] > 0) == (scenario.regularizer == "tv"),
                f"zoo tv_prox launches {row}")
        require((launches["batched_affine"] > 0)
                == (scenario.loss == "squared"),
                f"zoo batched_affine launches {row}")
        require(launches["fused_pd_step"] == 0
                and route_launches["fused_pd_step_variants"].get(
                    f"{scenario.loss}/float32", 0) > 0,
                f"zoo route launches {row}")
        require(bf16_launches["fused_pd_step_variants"].get(
                    f"{scenario.loss}/bfloat16", 0) > 0,
                f"zoo bf16 launches {row}")
        require(b_obj_rel <= 0.15 and b_w_rel <= 0.5,
                f"zoo bf16 vs dense f32 gates {row}")
        require(bool(torch.isfinite(unfused.w).all()
                     and torch.isfinite(bf16.w).all()), f"zoo w {row}")
    emit({"phase": "zoo", "seconds": time.perf_counter() - t0,
          "num_iters": base.num_iters, "rho": base.rho,
          "tol_w": SOLVE_TOL, "tol_objective_rel": ZOO_OBJ_RTOL,
          "bf16_gates": {"objective_rel": 0.15, "w_rel": 0.5},
          "scenarios": rows})


def phase_tol(torch) -> None:
    """Tolerance stopping on the §5 instance at lambda 1e-2 (``tests/
    test_device_stop.py``'s settings): a dense and a fused tol solve,
    each after a warm-up, under ``torch.cuda.set_sync_debug_mode
    ("error")`` so that any host synchronization but the port's one
    fetch raises; then the same solve cut at its stopping iteration, so
    the difference is what the launches after the stop cost."""
    from repro_torch.api import Problem, SolverConfig
    from repro_torch.data.synthetic import make_sbm_regression

    t0 = time.perf_counter()
    ds = make_sbm_regression(seed=0)
    problem = Problem.create(ds.graph, ds.data, 1e-2)
    cfg = SolverConfig(num_iters=4000, rho=1.9, metric_every=10, tol=5e-3,
                       compute_diagnostics=False)
    rows, results = {}, {}
    for name, path in (("dense", dict(backend="dense")),
                       ("fused", dict(backend="pallas", fused=True))):
        row, result = tol_solve(torch, problem, cfg.replace(**path))
        require(row["fetches"] == 1, f"tol {name}: {row['fetches']} fetches")
        require(0 < row["iterations"] < cfg.num_iters,
                f"tol {name} did not stop: {row}")
        rows[name], results[name] = row, result
    # no block runs after the stop: the wrapper launches block 0, the
    # graph's replays run the kernel once a block up to the stop
    require(rows["fused"]["launches"]["fused_pd_step"] == 1
            and rows["fused"]["device_executions"]["fused_pd_step"]
            == rows["fused"]["iterations"] // cfg.metric_every,
            f"tol fused launches {rows['fused']}")
    dw = max_diff(results["fused"].w, results["dense"].w)
    emit({"phase": "tol", "seconds": time.perf_counter() - t0,
          "instance": "make_sbm_regression(seed=0), lam 1e-2",
          "config": {"num_iters": cfg.num_iters, "rho": cfg.rho,
                     "metric_every": cfg.metric_every, "tol": cfg.tol},
          "max_abs_dw_fused_vs_dense": dw, **rows})
    require(rows["fused"]["iterations"] == rows["dense"]["iterations"],
            f"tol: fused and dense stopped apart {rows}")
    require(dw <= SOLVE_TOL, f"tol fused vs dense |dw| = {dw}")


def tol_solve(torch, problem, cfg) -> tuple[dict, object]:
    """One tol solve after a warm-up, timed, under sync debug mode
    "error", with its fetch count, launches and the kernels' runs on the
    card; then the same solve as a fixed budget of its stopping
    iteration, timed."""
    from repro_torch.api import Solver
    from repro_torch.engine import device_fetch

    Solver(cfg).run(problem)                  # warm-up: layout, handles
    torch.cuda.synchronize()
    fetches = device_fetch.calls
    reset_launches()
    executions = {}
    with device_executions(torch, executions):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            result = Solver(cfg).run(problem)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = read_launches()
    fetched = device_fetch.calls - fetches
    it = result.diagnostics["iterations"]
    cut_cfg = cfg.replace(num_iters=it, tol=None)
    Solver(cut_cfg).run(problem)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cut = Solver(cut_cfg).run(problem)
    torch.cuda.synchronize()
    cut_s = time.perf_counter() - t0
    require(torch.equal(cut.w, result.w),
            "tol: the blocks after the stop moved the state")
    blocks = cfg.num_iters // cfg.metric_every
    return {"iterations": it, "fetches": fetched, "seconds": wall,
            "seconds_cut_at_stop": cut_s,
            "seconds_after_stop": wall - cut_s,
            "blocks_after_stop": blocks - it // cfg.metric_every,
            "launches": launches, "device_executions": executions}, result


@contextlib.contextmanager
def plain_tol_engine():
    """Run every tol engine on its plain version
    (``engine.loop.device_loop_plain``: every block of the budget
    enqueued, the blocks after the stop computed and dropped), the
    loop the earlier slices shipped."""
    from repro_torch.api import backends, solver
    from repro_torch.engine import loop
    saved = backends.device_loop, solver.device_loop
    backends.device_loop = solver.device_loop = loop.device_loop_plain
    try:
        yield
    finally:
        backends.device_loop, solver.device_loop = saved


def result_leaves(result) -> list:
    """The tensors and stopping iterations of a result (or of a list of
    them), for a bit-for-bit comparison."""
    if isinstance(result, (list, tuple)):
        return [x for r in result for x in result_leaves(r)]
    its = result.diagnostics.get("iterations")
    return [result.w, result.u, result.objective, result.mse,
            result.residual, None if its is None else np.asarray(its)]


def bit_identical(a, b) -> bool:
    import torch
    for x, y in zip(result_leaves(a), result_leaves(b), strict=True):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and torch.equal(x, y)):
                return False
        elif isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                return False
        elif x is not y:
            return False
    return True


def engine_pair(torch, run, *, warm_up: bool = True) -> tuple[dict, object]:
    """``run()`` (a tol solve) through the graph engine under sync debug
    mode "error" — timed, its fetches, its kernels' launches and their
    runs on the card (replays included) counted — and through the plain
    loop, timed and counted; the two results compared bit for bit.
    Returns ``(row, graph result)``."""
    from repro_torch.engine import device_fetch

    if warm_up:
        run()                                 # handles, layouts, kernels
    torch.cuda.synchronize()
    fetches = device_fetch.calls
    reset_launches()
    executions = {}
    with device_executions(torch, executions):
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fetched = device_fetch.calls - fetches
    launches = read_launches()
    reset_launches()
    with plain_tol_engine():
        t0 = time.perf_counter()
        plain = run()
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
    plain_launches = read_launches()
    same = bit_identical(got, plain)
    return {"seconds": wall, "plain_seconds": plain_wall,
            "fetches": fetched, "bit_identical_to_plain": same,
            "launches": launches, "device_executions": executions,
            "plain_launches": plain_launches}, got


def tol_engine_s5(torch) -> dict:
    """``phase_tol_engine`` on the §5 instance: every tol engine against
    its plain version, bit for bit, one fetch a solve (two for a path:
    its warm solve's and the sweep's).  Returns the rows."""
    from repro_torch.api import (Problem, Solver, SolverConfig, solve_many,
                                 solve_path)
    from repro_torch.data.synthetic import make_sbm_regression

    ds = make_sbm_regression(seed=0)
    s5 = Problem.create(ds.graph, ds.data, 1e-2)
    cfg = SolverConfig(num_iters=4000, rho=1.9, metric_every=10, tol=5e-3,
                       compute_diagnostics=False)
    pallas = cfg.replace(backend="pallas", fused=False)
    runs = {
        "dense": lambda: Solver(cfg).run(s5),
        "fused": lambda: Solver(cfg.replace(backend="pallas",
                                            fused=True)).run(s5),
        "batched": lambda: solve_many(
            [s5, s5.with_lam(2e-2), s5.with_lam(5e-3)], pallas),
        "masked": lambda: solve_path(
            s5, (0.3, 0.003, 0.1, 0.03),
            pallas.replace(warm_iters=3000, final_iters=2000))}
    rows = {}
    for name, run in runs.items():
        row, got = engine_pair(torch, run)
        its = (np.asarray(got.diagnostics["iterations"])
               if not isinstance(got, list)
               else got[0].diagnostics["iterations"])
        row["iterations"] = np.asarray(its).tolist()
        rows[f"s5_{name}"] = row
        # a path's warm solve is a tol solve too: its fetch and the sweep's
        want = 2 if name == "masked" else 1
        require(row["fetches"] == want and row["bit_identical_to_plain"],
                f"tol_engine §5 {name}: {row}")
    # the wrapper launches block 0; the kernel runs once a block to the
    # stop (the replays after it run nothing); the plain loop launches
    # every block of the budget
    blocks = rows["s5_fused"]["iterations"] // cfg.metric_every
    require(rows["s5_fused"]["launches"]["fused_pd_step"] == 1
            and rows["s5_fused"]["device_executions"]["fused_pd_step"]
            == blocks
            and rows["s5_fused"]["plain_launches"]["fused_pd_step"]
            == cfg.num_iters // cfg.metric_every,
            f"tol_engine §5 fused launches {rows['s5_fused']}")
    # the batch: one tv_prox and one batched_affine a step to the stop
    steps = rows["s5_batched"]["iterations"]
    ex = rows["s5_batched"]["device_executions"]
    require(ex["tv_prox"] == steps and ex["batched_affine"] == steps
            and rows["s5_batched"]["launches"]["tv_prox"]
            == cfg.metric_every, f"tol_engine §5 batched {rows['s5_batched']}")
    return rows


def phase_tol_engine(torch, big, full_tol: float) -> None:
    """The tol engines that stop computing at the stop (ROADMAP §3 F3):
    on the card a metric block is captured into a CUDA graph under an
    IF node on the device flag and replayed over the budget.  Each
    engine against its plain version (every block enqueued), bit for
    bit — ``w``, ``u``, traces and stopping iterations — with one fetch
    a solve under sync debug mode "error": the dense, fused, batched
    (``solve_many``) and masked (``solve_path`` with tol) engines on the
    §5 instance at lambda 1e-2 (``phase_tol``'s settings), and at full
    size the dense, fused, batched and masked engines at cut budgets
    (each tol from a probe of tol 0 that names the stopping block).
    Then a dense full-size tol solve at budget B and 4B: equal results,
    wall times within 10%."""
    from repro_torch.api import (Solver, SolverConfig, backends, solve_many,
                                 solver)

    t0 = time.perf_counter()
    rows = tol_engine_s5(torch)

    # full size: cut budgets, each tol from a probe that never stops
    me = 25
    dense = SolverConfig(num_iters=1000, rho=1.9, metric_every=me,
                         tol=0.0, compute_diagnostics=False)
    probe = Solver(dense).run(big)
    trace = probe.residual.cpu().numpy()
    tol = float(trace[7])
    expected = (int(np.argmax(trace <= tol)) + 1) * me
    del probe
    row, got = engine_pair(torch, lambda: Solver(dense.replace(tol=tol)).run(
        big), warm_up=False)
    row.update(tol=tol, iterations=got.diagnostics["iterations"],
               expected_iterations=expected, budget=dense.num_iters)
    rows["full_dense"] = row
    require(row["fetches"] == 1 and row["bit_identical_to_plain"]
            and row["iterations"] == expected,
            f"tol_engine full-size dense {row}")
    # budget B against 4B: the replays after the stop cost next to
    # nothing, so the wall times agree within 10%
    walls = {}
    for budget in (dense.num_iters, 4 * dense.num_iters):
        run_cfg = dense.replace(tol=tol, num_iters=budget)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = Solver(run_cfg).run(big)
        torch.cuda.synchronize()
        walls[budget] = (time.perf_counter() - t1, r)
    (wb, rb), (w4, r4) = walls.values()
    rows["full_dense_budgets"] = {
        "budgets": list(walls), "seconds": [wb, w4],
        "ratio_4b_over_b": w4 / wb,
        "iterations": [rb.diagnostics["iterations"],
                       r4.diagnostics["iterations"]],
        "equal_results": bool(torch.equal(rb.w, r4.w)
                              and torch.equal(rb.u, r4.u))}
    del walls, rb, r4
    require(rows["full_dense_budgets"]["equal_results"]
            and abs(w4 / wb - 1.0) <= 0.10,
            f"tol_engine budget B vs 4B {rows['full_dense_budgets']}")

    fused = SolverConfig(backend="pallas", fused=True, num_iters=2000,
                         rho=1.9, metric_every=100, tol=full_tol,
                         compute_diagnostics=False)
    row, got = engine_pair(torch, lambda: Solver(fused).run(big),
                           warm_up=False)
    row["iterations"] = got.diagnostics["iterations"]
    rows["full_fused"] = row
    require(row["fetches"] == 1 and row["bit_identical_to_plain"]
            and row["launches"]["fused_pd_step"] == 1
            and row["device_executions"]["fused_pd_step"]
            == row["iterations"] // fused.metric_every,
            f"tol_engine full-size fused {row}")

    two = [big, big.with_lam(2e-3)]
    batch = SolverConfig(backend="pallas", fused=False, num_iters=200,
                         rho=1.9, metric_every=20, tol=0.0,
                         record_residual=True, compute_diagnostics=False)
    probe = solve_many(two, batch)
    trace = torch.stack([r.residual for r in probe]).amax(0).cpu().numpy()
    btol = float(trace[3])
    del probe
    row, got = engine_pair(torch, lambda: solve_many(two, batch.replace(
        tol=btol)), warm_up=False)
    row.update(tol=btol, iterations=got[0].diagnostics["iterations"],
               budget=batch.num_iters)
    rows["full_batched"] = row
    require(row["fetches"] == 1 and row["bit_identical_to_plain"]
            and row["iterations"] < batch.num_iters,
            f"tol_engine full-size batched {row}")
    del got

    lams = np.asarray([1e-2, 1e-3], np.float32)
    hooks = backends.resolve_kernel_hooks(big, batch, True)
    params = big.loss.prox_setup(big.data, big.graph.primal_stepsizes())
    V, n, E = big.num_nodes, big.num_features, big.graph.num_edges

    def sweep(tol_):
        out = solver._masked_sweep_impl(
            big, lams, torch.zeros((2, V, n), device=big.device),
            torch.zeros((2, E, n), device=big.device), None, params, tol_,
            num_iters=batch.num_iters, rho=batch.rho,
            metric_every=batch.metric_every, clip_fn=hooks[0],
            affine_fn=hooks[1])
        torch.cuda.synchronize()
        return out

    res0 = sweep(0.0)[2][2].cpu().numpy()          # (blocks, lanes)
    mtol = float(res0[3].max())
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g = sweep(mtol)
    g_s = time.perf_counter() - t1
    with plain_tol_engine():
        t1 = time.perf_counter()
        p = sweep(mtol)
        p_s = time.perf_counter() - t1
    nb = int(g[4])                                 # the blocks that ran
    same = all(torch.equal(a, b) for a, b in
               zip((g[0], g[1], *(t[:nb] for t in g[2]), g[3], g[4]),
                   (p[0], p[1], *(t[:nb] for t in p[2]), p[3], p[4])))
    rows["full_masked"] = {"tol": mtol, "lams": lams.tolist(),
                           "iterations": g[3].cpu().tolist(),
                           "blocks": nb, "seconds": g_s,
                           "plain_seconds": p_s,
                           "bit_identical_to_plain": same}
    require(same and nb < batch.num_iters // batch.metric_every,
            f"tol_engine full-size masked {rows['full_masked']}")
    del g, p
    torch.cuda.empty_cache()
    emit({"phase": "tol_engine", "seconds": time.perf_counter() - t0,
          **rows})


def moving_state(torch, lt, n, la2, device, store):
    """Padded (w_store, u_store) of layout ``lt`` in dtype ``store``,
    from which the state still moves: w at the solve's scale (|w_true| =
    2), each dual drawn uniformly from its box [-la_e, la_e]."""
    eb, lo = lt.block_edges, lt.klo * lt.block_edges
    gen = torch.Generator(device=device).manual_seed(1)
    w_store = lt.pad_node_store(2.0 * torch.randn(
        (lt.nodes_pad, n), generator=gen, device=device))
    u_store = torch.zeros(((lt.num_blocks + lt.klo + lt.khi) * eb, n),
                          device=device)
    u_store[lo:lo + lt.edges_pad] = la2 * (2.0 * torch.rand(
        (lt.edges_pad, n), generator=gen, device=device) - 1.0)
    return w_store.to(store), u_store.to(store)


BF16_GATES = {"objective_rel": 0.15, "w_rel": 0.5}   # tests/test_precision.py


def dense_check(torch, got, want, dtype: str,
                w_limit: float = SOLVE_TOL) -> dict:
    """A fused solve against the dense backend's (float32): ``w`` within
    ``w_limit`` (SOLVE_TOL unless a float64 yardstick widens it) and the
    objective trace within rtol 1e-4; in bf16 storage the reference's
    gates (final objective 0.15 relative, ``w`` 0.5 of its scale)."""
    dw, obj_rel = compare(got, want)
    final_rel = float((got.objective[-1] - want.objective[-1]).abs()
                      / want.objective[-1].abs())
    w_rel = dw / float(want.w.abs().max())
    ok = (dw <= w_limit and obj_rel <= 1e-4 if dtype == "float32" else
          final_rel <= BF16_GATES["objective_rel"]
          and w_rel <= BF16_GATES["w_rel"])
    return {"max_abs_dw_vs_dense": dw, "limit_w": w_limit,
            "objective_max_rel_vs_dense": obj_rel,
            "final_objective_rel_vs_dense": final_rel,
            "w_rel_vs_dense": w_rel, "ok": ok}


def full_size_solve(torch, dev, cfg, problem, w_true, *, drift=False,
                    profile=False, name=None, dense_iters=None,
                    dense_cache=None, exact=False) -> tuple[dict, dict]:
    """One fused solve at full size (``cfg`` names its storage dtype),
    then the kernel alone and its plain version over one step and over
    one metric block from a random state at the solve's scale.  Returns
    (the phase row, the variant's entry for the kernels' line, under
    ``name``: the register-tile variant's by default).
    ``drift`` adds a float64 run of the plain version as a yardstick,
    ``profile`` a profiled metric block, ``dense_iters`` a fused solve of
    that budget (the solve itself where it is the solve's) against the
    dense backend's (``dense_check``; ``dense_cache``, a dict, keeps the
    dense solve for the next call on the same problem).  ``exact`` (a
    float32 solve held to dense over its whole budget) adds the float64
    yardstick of that comparison: the plain version in float64 on the
    solve's own float32 inputs over the same iterations from the same
    zero start, and ``w`` is then held within SOLVE_TOL or twice the
    dense solve's distance from it, where larger (float32 drift alone)."""
    from repro_torch.api import Solver, backends
    from repro_torch.engine import capped
    from repro_torch.kernels import ops
    from repro_torch.kernels.pd_step import plan_variant, variant_key

    loss, dtype = problem.loss.name, cfg.dtype
    store = getattr(torch, dtype)
    n = problem.num_features
    kind = {"squared": 0, "lasso": 1, "logistic": 2}[loss]
    staged = plan_variant(kind, n, problem.data.x.shape[-2]) == "staged"
    variant = variant_key(loss, store, n, staged)
    t0 = time.perf_counter()
    require(backends._should_fuse(problem, cfg), f"{variant}: no fusion")
    plan_s = time.perf_counter() - t0         # plans (or fetches) the layout
    lt = backends._graph_layout(problem.graph)

    iterations = (capped(cfg.warm_iters, cfg.metric_every)
                  + capped(cfg.final_iters, cfg.metric_every)
                  if cfg.continuation else cfg.num_iters)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reset_launches()
    result = Solver(cfg).run(problem, w_true=w_true)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    diag = {k: float(v) for k, v in result.diagnostics.items()}
    # bf16 stores a clipped dual rounded to nearest: up to half an ulp
    # of the clip level past it
    la_max = float(problem.lam * problem.graph.weights.max())
    infeasible_lim = 1e-6 + (bf16_ulp(la_max) / 2 if dtype == "bfloat16"
                             else 0.0)
    require(launches["fused_pd_step_variants"].get(variant, 0) > 0
            and launches["fused_pd_step"]
            == launches["fused_pd_step_variants"][variant],
            f"{variant} solve launches {launches}")
    require(bool(torch.isfinite(result.w).all()
                 and torch.isfinite(result.objective).all()),
            f"{variant} full-size result not finite")
    require(diag.get("dual_infeasibility", 0.0) <= infeasible_lim,
            f"{variant} full-size dual infeasible {diag}")

    (params_s, pkeys, _, tau_s, _, sig2, src2, dst2, la2, _) = \
        backends._fused_setup(problem.graph, problem.data, problem.lam,
                              None, loss=problem.loss,
                              reg=problem.regularizer, layout=lt,
                              dtype=store)
    eb, lo = lt.block_edges, lt.klo * lt.block_edges
    tables = (lt.pad_node_store(lt.inc_edges),
              lt.pad_node_store(lt.inc_signs), params_s, tau_s, src2, dst2,
              sig2, la2)
    kw = dict(loss=problem.loss, reg=problem.regularizer, pkeys=pkeys,
              block_nodes=lt.block_nodes, block_edges=eb, kn=lt.kn,
              klo=lt.klo, khi=lt.khi, rho=cfg.rho, incidence=lt.compact)

    def run_block(fn, args, iters):
        """``iters`` iterations from ``args``' state, launched as the
        solve launches them (one launch on a whole-graph layout)."""
        if lt.num_blocks == 1:
            return fn(*args, **kw, iters=iters)
        ws, us = args[0].clone(), args[1].clone()
        for _ in range(iters):
            wn, un = fn(ws, us, *args[2:], **kw)
            ws[:wn.shape[0]] = wn
            us[lo:lo + un.shape[0]] = un
        return wn, un

    def metric_block(fn, args):
        """One metric block from the shared state."""
        return run_block(fn, args, cfg.metric_every)

    def f64(t):
        return t.double() if t.is_floating_point() else t

    dense_row = None
    if dense_iters is not None:
        fused = result if dense_iters == iterations else Solver(
            cfg.replace(continuation=False, num_iters=dense_iters)).run(
                problem, w_true=w_true)
        t0 = time.perf_counter()
        cache = {} if dense_cache is None else dense_cache
        key = (id(problem), dense_iters)
        if key not in cache:
            cache[key] = Solver(cfg.replace(
                backend="dense", dtype="float32", continuation=False,
                num_iters=dense_iters)).run(problem, w_true=w_true)
        want = cache[key]
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t0
        w_limit, yardstick = SOLVE_TOL, {}
        if exact:
            require(dtype == "float32" and dense_iters == iterations
                    and not cfg.continuation,
                    f"{variant}: the float64 yardstick needs the float32 "
                    "solve's whole budget from a zero start")
            t0 = time.perf_counter()
            zeros = (torch.zeros((lt.nodes_pad + (lt.kn - 1)
                                  * lt.block_nodes, n), dtype=torch.float64,
                                 device=dev),
                     torch.zeros(((lt.num_blocks + lt.klo + lt.khi) * eb, n),
                                 dtype=torch.float64, device=dev))
            args64 = zeros + tuple(tuple(map(f64, a)) if isinstance(a, tuple)
                                   else f64(a) for a in tables)
            w_x = run_block(plain_step, args64, iterations)[0]
            del args64, zeros
            w_x = w_x[:lt.nodes_pad][lt.node_inv.long()]
            yardstick = {
                "iterations": iterations,
                "seconds": time.perf_counter() - t0,
                "dense_dw_from_f64": max_diff(want.w, w_x),
                "fused_dw_from_f64": max_diff(fused.w, w_x)}
            del w_x
            torch.cuda.empty_cache()
            w_limit = max(SOLVE_TOL, 2.0 * yardstick["dense_dw_from_f64"])
        dense_row = {"iterations": dense_iters, "dense_seconds": dense_s,
                     **dense_check(torch, fused, want, dtype, w_limit)}
        if yardstick:
            dense_row["f64_yardstick"] = yardstick
        del fused, want
        require(dense_row["ok"], f"{variant} full size vs dense {dense_row}")

    # the kernel alone at the target lambda, from a state that moves
    w_store, u_store = moving_state(torch, lt, n, la2, dev, store)
    args = (w_store, u_store) + tables
    ms = cuda_ms(lambda _: ops.pd_step(*args, **kw), reps=20)
    plain_ms = cuda_ms(lambda _: plain_step(*args, **kw), reps=3)
    block_iters = cfg.metric_every if lt.num_blocks == 1 else 1
    block_ms = cuda_ms(
        lambda _: ops.pd_step(*args, **kw, iters=block_iters), reps=3)
    cost = step_cost(args, kw, problem.loss)

    k_out = metric_block(ops.pd_step, args)
    p_out = metric_block(plain_step, args)
    dw, du = max_diff(k_out[0], p_out[0]), max_diff(k_out[1], p_out[1])
    # float32 drift over the block, plus, for the single rounding of a
    # bf16 launch, one bf16 ulp at the scale of w and of u
    def limit_of(t):
        ulp = bf16_ulp(float(t.float().abs().max()))
        return SOLVE_TOL + (ulp if dtype == "bfloat16" else 0.0)
    lim_w, lim_u = limit_of(p_out[0]), limit_of(p_out[1])
    # how far the plain version moved the state: a wrong kernel is caught
    # only where the state moves well beyond the limit
    moved_w = max_diff(p_out[0], w_store[:p_out[0].shape[0]])
    moved_u = max_diff(p_out[1], u_store[lo:lo + p_out[1].shape[0]])
    row = {"loss": loss, "dtype": dtype, "nodes": problem.num_nodes,
           "edges": problem.graph.num_edges,
           "num_features": n, "lam": problem.lam,
           "layout": {"num_blocks": lt.num_blocks,
                      "block_nodes": lt.block_nodes, "block_edges": eb,
                      "kn": lt.kn, "klo": lt.klo, "khi": lt.khi},
           "plan_seconds": plan_s, "solve_seconds": solve_s,
           "iterations": iterations, "continuation": cfg.continuation,
           "iterations_per_s": iterations / solve_s, "launches": launches,
           "kernel_ms_per_step": ms,
           "kernel_ms_per_launch": {"iters": block_iters, "ms": block_ms},
           "plain_ms_per_step": plain_ms, **cost,
           "max_memory_allocated": peak,
           "mse_last": float(result.mse[-1]),
           "objective_last": float(result.objective[-1]),
           "diagnostics": diag, "block_iters": cfg.metric_every,
           "block_max_abs_dw": dw, "block_max_abs_du": du,
           "block_limit_w": lim_w, "block_limit_u": lim_u,
           "plain_moved_max_abs_w": moved_w,
           "plain_moved_max_abs_u": moved_u, "variant": variant,
           "dense": dense_row}
    if drift:
        # the plain version in float64 as a yardstick: how far each
        # float32 version drifts from exact arithmetic over the block
        args64 = tuple(tuple(map(f64, a)) if isinstance(a, tuple)
                       else f64(a) for a in args)
        x_out = metric_block(plain_step, args64)
        row["block_drift_from_f64"] = {
            "kernel_dw": max_diff(k_out[0], x_out[0]),
            "kernel_du": max_diff(k_out[1], x_out[1]),
            "plain_dw": max_diff(p_out[0], x_out[0]),
            "plain_du": max_diff(p_out[1], x_out[1])}
    if profile:
        block_cfg = cfg.replace(continuation=False,
                                num_iters=cfg.metric_every,
                                compute_diagnostics=False)
        row["profile_one_metric_block"] = device_profile(
            torch, lambda _: Solver(block_cfg).run(problem), reps=1)
    require(dw <= lim_w and du <= lim_u,
            f"{variant} full size, {cfg.metric_every} iterations: |dw| {dw}, "
            f"|du| {du}, limits {lim_w}, {lim_u}")
    require(moved_w >= 10 * lim_w and moved_u >= 10 * lim_u,
            f"{variant} full size: the state barely moved (|w| {moved_w}, "
            f"|u| {moved_u}), so the comparison shows nothing")
    name = name or variant_name(loss, dtype)
    entry = dict(KERNELS[name],
                 launches=launches["fused_pd_step_variants"][variant],
                 max_abs_err=max(dw, du), ms=ms, plain_ms=plain_ms,
                 bound_ms=cost["bound_ms"], bound_by=cost["bound_by"],
                 library_ms=None)
    return row, entry


def phase_full_size(torch, dev, cfg, big, w_true, gen_s) -> tuple:
    """The scale-out topology at FULL_NODES through the fused path
    (squared loss, float32), the kernel alone and its plain version, a
    float64 yardstick and a profiled metric block.  Returns the kernel's
    entry for the kernels' line, the solve's iterations/s, the layout's
    planning seconds and the certificate's ``sym_pinv`` launches (its
    diagnostics)."""
    from repro_torch.api import backends

    row, entry = full_size_solve(torch, dev, cfg, big, w_true, drift=True,
                                 profile=True)
    csr_s = compact_build_seconds(backends._graph_layout(big.graph))
    emit({"phase": "full_size", "generate_seconds": gen_s,
          "compact_incidence_build_seconds": csr_s,
          "max_degree": big.graph.max_degree, **row})
    require(row["launches"]["sym_pinv"] >= 1,
            f"the full-size certificate's sym_pinv launches {row['launches']}")
    return (entry, row["iterations_per_s"], row["plan_seconds"],
            row["launches"]["sym_pinv"])


def phase_full_size_variants(torch, dev, cfg, big, w_true, others) -> list:
    """The other five variants at full size on the same graph: the
    squared continuation solve in bf16, and fixed-budget solves of the
    logistic and lasso instances (``loss_instances``) in float32 and
    bf16.  Returns their entries for the kernels' line."""
    t0 = time.perf_counter()
    fixed = cfg.replace(continuation=False, num_iters=1000)
    runs = [(cfg.replace(dtype="bfloat16"), big, w_true)]
    for loss in ("logistic", "lasso"):
        problem, truth = others[loss]
        runs += [(fixed.replace(dtype=dt), problem, truth)
                 for dt in ("float32", "bfloat16")]
    rows, entries = [], []
    for run_cfg, problem, truth in runs:
        row, entry = full_size_solve(torch, dev, run_cfg, problem, truth)
        rows.append(row)
        entries.append(entry)
    emit({"phase": "full_size_variants",
          "seconds": time.perf_counter() - t0, "runs": rows})
    return entries


def phase_full_size_tol(torch, cfg, big) -> float:
    """A fused tol solve at full size (squared, float32).  A first solve
    with tol 0 never stops and records every block's residual; tol is
    then set to the residual of block 10, so the tol solve must stop
    after the first block at or below it, which the probe's trace
    names.  The tol solve runs under sync debug mode "error" with its
    one fetch, then cut at its stop (``tol_solve``)."""
    from repro_torch.api import Solver

    t0 = time.perf_counter()
    probe_cfg = cfg.replace(continuation=False, num_iters=2000, tol=0.0,
                            compute_diagnostics=False)
    probe = Solver(probe_cfg).run(big)
    trace = probe.residual.cpu().numpy()
    require(probe.diagnostics["iterations"] == probe_cfg.num_iters
            and trace.shape == (20,), f"tol probe {probe.diagnostics}")
    tol = float(trace[9])
    expected = (int(np.argmax(trace <= tol)) + 1) * cfg.metric_every
    row, result = tol_solve(torch, big, probe_cfg.replace(tol=tol))
    emit({"phase": "full_size_tol", "seconds": time.perf_counter() - t0,
          "tol": tol, "probe_residuals": trace.tolist(),
          "expected_iterations": expected, **row})
    require(row["fetches"] == 1, f"full-size tol fetches {row}")
    require(row["iterations"] == expected,
            f"full-size tol stopped at {row['iterations']}, not {expected}")
    require(bool(torch.isfinite(result.w).all()), "full-size tol w")
    return tol


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
    # the bf16 instantiation at the same shape: on no solve path (bf16 is
    # a fused-path policy), timed and held bit-equal all the same
    u16 = u.to(torch.bfloat16)
    lo16, hi16 = lo.to(torch.bfloat16), hi.to(torch.bfloat16)
    tv16_err = max_diff(tv_prox(u16, bnd), tv_prox_ref(u16, bnd))
    tv16 = {"max_abs_err": tv16_err,
            "ms": cuda_ms(lambda _: tv_prox(u16, bnd), reps=50),
            "plain_ms": cuda_ms(lambda _: tv_prox_ref(u16, bnd), reps=50),
            "library_ms": cuda_ms(lambda _: torch.clamp(u16, lo16, hi16),
                                  reps=50),
            **bound(2 * u.numel() + 4 * bnd.numel(), 2 * u.numel(),
                    2 * u.numel())}

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
          "tv_prox_bf16": tv16,
          "tv_prox": {"shape": [e, n], "max_abs_err": tv_err,
                      "clipped_share": clipped, **tv_times, **tv_cost,
                      "profile": tv_prof},
          "batched_affine": {"shape": [v_nodes, n, n],
                             "max_abs_err": affine_err,
                             "timing_copies": copies,
                             "timing_bytes_in_rotation": copies * per_copy,
                             **affine_times, **affine_cost,
                             "profile": affine_prof}})
    require(tv_err == 0.0 and tv16_err == 0.0,
            f"full-size tv_prox vs plain |d| = {tv_err}, bf16 {tv16_err}")
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

# ---------------------------------------------------------------------------
# Lambda paths and batched solves: every kernel over a lane axis
# ---------------------------------------------------------------------------

def lane_args(torch, args, lanes: int):
    """``step_inputs``' one-lane arguments as ``lanes`` lanes of a lambda
    path, as ``solve_path`` starts them: one w shared by every lane (the
    warm start), lambda from 1x to 0.1x the one lane's (la and the duals
    in its box scaled with it); the tables and prox parameters shared."""
    scale = np.geomspace(1.0, 0.1, lanes)
    out = list(args)
    out[0] = torch.stack([args[0]] * lanes)
    out[1] = torch.stack([args[1] * float(s) for s in scale])
    out[9] = torch.stack([args[9] * float(s) for s in scale])
    return out


def one_lane(args, lane: int):
    out = list(args)
    out[0], out[1], out[9] = args[0][lane], args[1][lane], args[9][lane]
    return out


def phase_lanes_vs_plain(torch, dev) -> dict:
    """Every kernel's lane axis at small shapes: one launch over three
    lanes against the plain version over three lanes (as
    ``kernel_vs_plain`` holds one lane: STEP_TOL for one iteration, the
    metric block's SOLVE_TOL for a five-iteration launch) and against
    three one-lane launches (bit-identical: each lane sums in the
    one-lane order).
    Returns the max error per lane kernels' line name."""
    from repro_torch.api.regularizers import SquaredTV, TotalVariation
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import batched_affine_ref, tv_prox_ref
    from repro_torch.kernels.ridge_prox import batched_affine
    from repro_torch.kernels.tv_prox import tv_prox

    t0 = time.perf_counter()
    regs = {"tv": TotalVariation(), "tv2": SquaredTV()}
    names = {v: k for k, v in LANE_KERNELS.items()}
    errs = dict.fromkeys(list(LANE_KERNELS) + [
        "tv_prox[lanes]", "batched_affine[lanes,shared P]",
        "batched_affine[lanes,per-lane P]"], 0.0)
    rows = []
    for loss, dt in VARIANTS:
        for v, n, bv, rho, reg, iters in ((61, 2, 16, 1.9, "tv", 1),
                                          (64, 8, 16, 1.0, "tv2", 1),
                                          (48, 16, None, 1.9, "tv", 5)):
            args, kw = step_inputs(v, n, bv, seed=v, device=dev, loss=loss,
                                   dtype=dt)
            kw.update(loss=port_loss(loss), reg=regs[reg], rho=rho,
                      iters=iters, compute_residual=True)
            largs = lane_args(torch, args, 3)
            got = ops.pd_step(*largs, **kw)
            ones = [ops.pd_step(*one_lane(largs, k), **kw)
                    for k in range(3)]
            want = plain_step(*largs, **kw)
            torch.cuda.synchronize()
            # one call: the one-call limit; a multi-iteration launch: the
            # limit of a metric block (float32 drift between two sum
            # orders grows with the iterations and the state's scale)
            checks = [check_step(torch, [g[k] for g in got],
                                 [w[k] for w in want], args, dt,
                                 STEP_TOL if iters == 1 else SOLVE_TOL)
                      for k in range(3)]
            row = {"loss": loss, "dtype": dt, "v": v, "n": n, "bv": bv,
                   "reg": reg, "iters": iters, "lanes": 3,
                   "bit_identical_to_one_lane_launches": all(
                       torch.equal(g[k], o)
                       for k, one in enumerate(ones)
                       for g, o in zip(got, one)),
                   "dw": max(c["dw"] for c in checks),
                   "du": max(c["du"] for c in checks),
                   "dres": max(c["dres"] for c in checks),
                   "ok": all(c["ok"] for c in checks)}
            rows.append(row)
            require(row["ok"], f"lane kernel vs plain version {row}")
            require(row["bit_identical_to_one_lane_launches"],
                    f"lane launch differs from one-lane launches {row}")
            key = f"{loss}/{dt}"
            if key in names:
                errs[names[key]] = max(errs[names[key]], row["dw"],
                                       row["du"])
    gen = torch.Generator(device=dev).manual_seed(0)
    tv_rows = []
    for dt in ("float32", "bfloat16"):
        level = torch.rand((4, 1001), generator=gen, device=dev)
        u = (4.0 * torch.rand((4, 1001, 3), generator=gen, device=dev)
             - 2.0).to(getattr(torch, dt))
        got = tv_prox(u, level)
        d = max_diff(got, tv_prox_ref(u, level))
        ident = all(torch.equal(got[k], tv_prox(u[k].contiguous(),
                                                level[k].contiguous()))
                    for k in range(4))
        tv_rows.append({"dtype": dt, "max_abs_err": d,
                        "bit_identical_to_one_lane_launches": ident})
        require(d == 0.0 and ident, f"tv_prox lanes {tv_rows[-1]}")
    affine_rows = []
    for shared in (True, False):
        x = torch.randn((4, 999, 5), generator=gen, device=dev)
        p = torch.randn((999, 5, 5) if shared else (4, 999, 5, 5),
                        generator=gen, device=dev)
        got = batched_affine(p, x)
        d = max_diff(got, batched_affine_ref(p, x))
        ident = all(torch.equal(got[k], batched_affine(
            p if shared else p[k].contiguous(), x[k].contiguous()))
            for k in range(4))
        affine_rows.append({"shared_p": shared, "max_abs_err": d,
                            "bit_identical_to_one_lane_launches": ident})
        require(d <= AFFINE_TOL and ident,
                f"batched_affine lanes {affine_rows[-1]}")
        name = ("batched_affine[lanes,shared P]" if shared
                else "batched_affine[lanes,per-lane P]")
        errs[name] = d
    torch.cuda.synchronize()
    emit({"phase": "lanes_vs_plain", "seconds": time.perf_counter() - t0,
          "fused_pd_step": rows, "tv_prox": tv_rows,
          "batched_affine": affine_rows})
    return errs


def phase_wide_vs_plain(torch, dev) -> dict:
    """The wide (n > 16: a node a warp) and streamed (prox parameters read
    from device memory) variants of ``fused_pd_step`` against the plain
    version at small shapes: every loss x {float32, bfloat16} x n in
    WIDE_NS, one call on a banded layout (STEP_TOL; bf16 one ulp) and a
    100-iteration launch on the whole-graph block (SOLVE_TOL; bf16 one
    ulp; the squared loss with a ridge prox's P); float32 limits grow to
    twice the plain version's own distance from its float64 run where
    that is larger; three lanes in one launch, each bit-identical to a one-lane
    launch; the wide streamed variant forced on the same inputs,
    bit-identical to the staged one (both read each parameter as its
    storage value widened to float32 and run the same arithmetic).  The
    register tile's streamed logistic variant forced where the staged one
    applies (7,000 samples at n = 2): within STEP_TOL (bf16 one ulp) of
    the staged launch and of the plain version (it sums a labeled node's
    samples over a block, in another order), bit-identical over two
    launches.  Then the plan's own streamed launches: logistic nodes of
    15,000 samples at n = 2 (the register tile), squared and lasso at n =
    256 (P / Q alone 256 KB a node) and logistic at n = 32 with 2,000
    samples (the wide kernel).  Returns the max error per kernels' line
    name."""
    from repro_torch.api.regularizers import SquaredTV, TotalVariation
    from repro_torch.kernels import ops
    from repro_torch.kernels.pd_step import (fused_pd_step, plan_variant,
                                             variant_key)

    t0 = time.perf_counter()
    regs = {"tv": TotalVariation(), "tv2": SquaredTV()}
    kinds = {"squared": 0, "lasso": 1, "logistic": 2}
    errs = dict.fromkeys(NEW_VARIANTS, 0.0)

    def note(key, err):
        for name, (k, _) in NEW_VARIANTS.items():
            if k == key:
                errs[name] = max(errs[name], err)

    def streamed(args, kw):
        return forced_streamed(fused_pd_step, args, kw)

    rows = []
    for loss, dt in VARIANTS:
        edges = (LAST_STAGED, LAST_STAGED + 1) if loss != "logistic" else ()
        for n in WIDE_NS + edges:
            reg = regs["tv" if n % 2 else "tv2"]
            args, kw = step_inputs(40, n, 16, seed=n, device=dev, loss=loss,
                                   dtype=dt)
            kw.update(loss=port_loss(loss), reg=reg, rho=1.9,
                      compute_residual=True)
            ms = args[4][4].shape[1] if loss == "logistic" else 0
            plan = plan_variant(kinds[loss], n, ms)
            if n >= LAST_STAGED:
                require(plan == ("staged" if n == LAST_STAGED
                                 else "streamed"),
                        f"{loss} at n = {n}: plan {plan}")
            got = ops.pd_step(*args, **kw)
            forced = streamed(args, kw)
            want = plain_step(*args, **kw)
            exact = plain_step(*f64_args(args), **kw)
            largs = lane_args(torch, args, 3)
            lanes = ops.pd_step(*largs, **kw)
            ones = [ops.pd_step(*one_lane(largs, k), **kw) for k in range(3)]
            b_args, b_kw = step_inputs(48, n, None, seed=n + 1, device=dev,
                                       loss=loss, dtype=dt, ridge=True)
            b_kw.update(loss=port_loss(loss), reg=reg, rho=1.9, iters=100,
                        compute_residual=True)
            block = ops.pd_step(*b_args, **b_kw)
            b_want = plain_step(*b_args, **b_kw)
            b_exact = plain_step(*f64_args(b_args), **b_kw)
            torch.cuda.synchronize()
            one_call = check_step(torch, got, want, args, dt, exact=exact)
            hundred = check_step(torch, block, b_want, b_args, dt, SOLVE_TOL,
                                 exact=b_exact)
            row = {"loss": loss, "dtype": dt, "n": n, "plan": plan,
                   "one_call": one_call, "iters_100": hundred,
                   "streamed_bit_identical_to_staged": all(
                       torch.equal(a, b) for a, b in zip(got, forced)),
                   "lanes_bit_identical_to_one_lane_launches": all(
                       torch.equal(g[k], o) for k, one in enumerate(ones)
                       for g, o in zip(lanes, one))}
            rows.append(row)
            require(one_call["ok"] and hundred["ok"],
                    f"wide variant vs plain version {row}")
            require(row["streamed_bit_identical_to_staged"]
                    and row["lanes_bit_identical_to_one_lane_launches"],
                    f"wide variant bits {row}")
            note(variant_key(loss, getattr(torch, dt), n, plan == "staged"),
                 max(one_call["dw"], one_call["du"], hundred["dw"],
                     hundred["du"]))
    # the register tile's streamed variant, forced where both apply
    tile_rows = []
    for dt in ("float32", "bfloat16"):
        args, kw = step_inputs(40, 2, 16, seed=2, device=dev,
                               loss="logistic", dtype=dt, samples=7000)
        kw.update(loss=port_loss("logistic"), reg=regs["tv"], rho=1.9,
                  compute_residual=True)
        staged = ops.pd_step(*args, **kw)
        forced = streamed(args, kw)
        again = streamed(args, kw)
        want = plain_step(*args, **kw)
        torch.cuda.synchronize()
        row = {"dtype": dt, "samples": 7000,
               "vs_staged": check_step(torch, forced, staged, args, dt),
               "vs_plain": check_step(torch, forced, want, args, dt),
               "bit_identical_relaunch": all(
                   torch.equal(a, b) for a, b in zip(forced, again))}
        tile_rows.append(row)
        require(row["vs_staged"]["ok"] and row["vs_plain"]["ok"]
                and row["bit_identical_relaunch"],
                f"logistic/{dt}: forced streamed vs staged and plain {row}")
        note(variant_key("logistic", getattr(torch, dt), 2, False),
             max(row["vs_plain"]["dw"], row["vs_plain"]["du"]))
    # the plan's own streamed launches
    streamed_rows = []
    for loss, n, samples in (("logistic", 2, 15_000), ("squared", 256, None),
                             ("lasso", 256, None), ("logistic", 32, 2000)):
        args, kw = step_inputs(24, n, 16, seed=n, device=dev, loss=loss,
                               samples=samples)
        kw.update(loss=port_loss(loss), reg=regs["tv"], rho=1.9,
                  compute_residual=True)
        ms = args[4][4].shape[1] if loss == "logistic" else 0
        plan = plan_variant(kinds[loss], n, ms)
        got = ops.pd_step(*args, **kw)
        want = plain_step(*args, **kw)
        exact = plain_step(*f64_args(args), **kw)
        torch.cuda.synchronize()
        check = check_step(torch, got, want, args, "float32", exact=exact)
        streamed_rows.append({"loss": loss, "n": n, "samples": ms,
                              "plan": plan, **check})
        require(plan == "streamed" and check["ok"],
                f"streamed by the plan {streamed_rows[-1]}")
        note(variant_key(loss, torch.float32, n, False),
             max(check["dw"], check["du"]))
    torch.cuda.synchronize()
    emit({"phase": "wide_vs_plain", "seconds": time.perf_counter() - t0,
          "widths": list(WIDE_NS) + [LAST_STAGED, LAST_STAGED + 1],
          "tol_f32": STEP_TOL,
          "tol_f32_100_iterations": SOLVE_TOL,
          "tol_bf16": "one bf16 ulp at the state's scale", "cases": rows,
          "register_tile_streamed_forced": tile_rows,
          "streamed_by_plan": streamed_rows,
          "max_abs_dw_du": errs})
    return errs


def lane_kernel_entry(torch, dev, problem, lams, store, launches: int,
                      rho: float, block: int,
                      name=None) -> tuple[dict, dict]:
    """The fused kernel over the path's lanes at full size, alone: ms per
    ``iters=1`` launch over every lane against the same lanes as one-lane
    launches side by side (whole, and each phase alone, ``one_phase``),
    the plain version over the lanes, the bound
    (shared tables once, each lane's state), and a ``block``-iteration
    launch held against the one-lane launches (bit-identical) and, in
    float32 for the squared loss at the register tile's widths, against
    the plain version.  For the wide and streamed variants the plain
    version runs a lane at a time (its gathers, or its predictions over
    every sample, for every lane at once would not fit the card).  ``name``: the kernels' line name (the register-tile
    lane variant's by default)."""
    from repro_torch.api import backends
    from repro_torch.kernels import ops

    lt = backends._graph_layout(problem.graph)
    (params_s, pkeys, _, tau_s, _, sig2, src2, dst2, la2, _) = \
        backends._fused_setup(problem.graph, problem.data, lams, None,
                              loss=problem.loss, reg=problem.regularizer,
                              layout=lt, dtype=store)
    n, lanes = problem.num_features, len(lams)
    states = [moving_state(torch, lt, n, la2[k], dev, store)
              for k in range(lanes)]
    args = (torch.stack([s[0] for s in states]),
            torch.stack([s[1] for s in states]),
            lt.pad_node_store(lt.inc_edges), lt.pad_node_store(lt.inc_signs),
            params_s, tau_s, src2, dst2, sig2, la2)
    del states
    kw = dict(loss=problem.loss, reg=problem.regularizer, pkeys=pkeys,
              block_nodes=lt.block_nodes, block_edges=lt.block_edges,
              kn=lt.kn, klo=lt.klo, khi=lt.khi, rho=rho,
              incidence=lt.compact)
    singles = [one_lane(args, k) for k in range(lanes)]
    ms = cuda_ms(lambda _: ops.pd_step(*args, **kw), reps=20)
    ones_ms = cuda_ms(lambda _: [ops.pd_step(*a, **kw) for a in singles],
                      reps=20)
    # each phase alone (the other's extent 0), lane launch and one-lane
    phases = {}
    for phase in ("node", "edge"):
        with one_phase(phase):
            phases[f"{phase}_phase_ms"] = cuda_ms(
                lambda _: ops.pd_step(*args, **kw), reps=20)
            phases[f"{phase}_phase_ms_one_lane_launches"] = cuda_ms(
                lambda _: [ops.pd_step(*a, **kw) for a in singles], reps=20)
    if name is None:
        def plain():
            return plain_step(*args, **kw)
    else:
        def plain():
            return [torch.stack(t) for t in zip(*[plain_step(*a, **kw)
                                                   for a in singles])]
    plain_ms = cuda_ms(lambda _: plain(), reps=2)
    step_got = ops.pd_step(*args, **kw)
    step_want = plain()
    dw = max_diff(step_got[0], step_want[0])
    du = max_diff(step_got[1], step_want[1])
    err = max(dw, du)
    block_iters = block if lt.num_blocks == 1 else 1
    got = ops.pd_step(*args, **kw, iters=block_iters)
    ones = [ops.pd_step(*a, **kw, iters=block_iters) for a in singles]
    ident = all(torch.equal(got[0][k], o[0]) and torch.equal(got[1][k], o[1])
                for k, o in enumerate(ones))
    row = {"lanes": lanes, "ms_per_launch": ms,
           "ms_one_lane_launches": ones_ms, **phases,
           "ms_per_lane": ms / lanes, "plain_ms": plain_ms,
           "step_max_abs_err_vs_plain": err,
           "block_iters": block_iters,
           "block_bit_identical_to_one_lane_launches": ident,
           **step_cost(args, kw, problem.loss)}
    # float32: the one-call limit; bf16: one ulp at each output's scale
    lim_w = lim_u = STEP_TOL
    if store == torch.bfloat16:
        lim_w = bf16_ulp(float(step_want[0].float().abs().max()))
        lim_u = bf16_ulp(float(step_want[1].float().abs().max()))
    row.update(step_dw=dw, step_du=du, limit_w=lim_w, limit_u=lim_u)
    require(dw <= lim_w and du <= lim_u,
            f"lane kernel vs plain at full size {row}")
    require(ident, f"lane launch vs one-lane launches at full size {row}")
    if (problem.loss.name == "squared" and store == torch.float32
            and n <= 16):
        # the block against the plain version: within SOLVE_TOL, or no
        # further than twice the plain version's own float32 drift from
        # float64 over the block (a lane at lambda 0.1 has a dual box
        # 100x the full_size phase's, and its drift grows with it)
        want = plain_step(*args, **kw, iters=block_iters)

        def f64(t):
            return t.double() if t.is_floating_point() else t
        args64 = tuple(tuple(map(f64, a)) if isinstance(a, tuple)
                       else f64(a) for a in args)
        exact = plain_step(*args64, **kw, iters=block_iters)
        for i, key in ((0, "w"), (1, "u")):
            drift = max_diff(want[i], exact[i])
            row[f"block_max_abs_d{key}"] = max_diff(got[i], want[i])
            row[f"block_plain_drift_from_f64_{key}"] = drift
            row[f"block_kernel_drift_from_f64_{key}"] = max_diff(got[i],
                                                                 exact[i])
            row[f"block_limit_{key}"] = max(SOLVE_TOL, 2.0 * drift)
            require(row[f"block_max_abs_d{key}"] <= row[f"block_limit_{key}"],
                    f"lane block vs plain at full size {row}")
        del want, args64, exact
    name = name or {v: k for k, v in LANE_KERNELS.items()}[
        f"{problem.loss.name}/{str(store).removeprefix('torch.')}"]
    entry = dict(KERNELS[name], launches=launches, max_abs_err=err, ms=ms,
                 plain_ms=plain_ms, bound_ms=row["bound_ms"],
                 bound_by=row["bound_by"], library_ms=None)
    del args, singles, got, ones, step_got, step_want
    torch.cuda.empty_cache()
    return row, entry


def path_run(torch, dev, problem, lams, cfg, w_true, *, dense=False,
             dense_lanes=(), singles=None):
    """``solve_path`` with the fused lanes on ``problem``, timed, with its
    launches and peak memory; then the lanes alone from the same warm
    start (timed: iterations per second per lane and for the sweep) and
    each lane (or the lanes ``singles``) against a one-lane fused solve
    from that start (bit-identical, or within PATH_TOL), and, with
    ``dense``, the dense
    path's sweep (1e-4 on w, rtol 1e-4 on the objective); the lanes
    ``dense_lanes`` against one-lane dense solves from the same start
    (1e-4 on w, rtol 1e-4 on the objective: where the dense path's lanes
    would not fit the card)."""
    from repro_torch.api import backends, solve_path
    from repro_torch.engine import capped, default_warm_lam
    from repro_torch.kernels.pd_step import plan_variant, variant_key

    n = problem.num_features
    kind = {"squared": 0, "lasso": 1, "logistic": 2}[problem.loss.name]
    variant = variant_key(problem.loss.name, getattr(torch, cfg.dtype), n,
                          plan_variant(kind, n, problem.data.x.shape[-2],
                                       len(lams)) == "staged")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = solve_path(problem, lams, cfg, w_true=w_true)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    warm_iters = capped(cfg.warm_iters, cfg.metric_every)
    final_iters = capped(cfg.final_iters, cfg.metric_every)
    # the path's duals are not compared: free them (~8 GB at n = 32 on
    # the full-size graph) before the lanes run again
    res = dataclasses.replace(res, u=None)
    lane_launches = launches["lanes"]["fused_pd_step"].get(variant, 0)
    # one launch per metric block on a whole-graph layout, else per step
    per = (cfg.metric_every
           if backends._graph_layout(problem.graph).num_blocks == 1 else 1)
    require(lane_launches == final_iters // per
            and launches["fused_pd_step"] == lane_launches
            + warm_iters // per, f"{variant} path launches {launches}")
    require(bool(torch.isfinite(res.w).all()
                 and torch.isfinite(res.objective).all()),
            f"{variant} path result not finite")

    # the lanes alone, from the same warm start (the kernel is
    # deterministic, so the warm solve gives the same bits again)
    warm_cfg = cfg.replace(continuation=False, compute_diagnostics=False,
                           record_residual=False, num_iters=warm_iters)
    warm = backends.solve_pallas(problem.with_lam(default_warm_lam(
        float(np.max(lams)))), warm_cfg)
    lam_col = backends.lane_values(lams, dev)[:, None]
    u0_b = problem.regularizer.project_dual(
        warm.u.expand((len(lams),) + tuple(warm.u.shape)), problem.graph,
        lam_col)
    final_cfg = cfg.replace(continuation=False, num_iters=final_iters)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lanes = backends._solve_fused(problem, final_cfg, w0=warm.w, u0=u0_b,
                                  w_true=w_true, lams=lams)
    torch.cuda.synchronize()
    lanes_s = time.perf_counter() - t0
    require(torch.equal(lanes.w, res.w), f"{variant}: the lanes alone "
            "differ from solve_path's")
    del lanes
    singles_s, dw_single, identical = 0.0, 0.0, True
    for k in (range(len(lams)) if singles is None else singles):
        lam = lams[k]
        t0 = time.perf_counter()
        one = backends._solve_fused(problem.with_lam(float(lam)), final_cfg,
                                    w0=warm.w, u0=u0_b[k], w_true=w_true)
        torch.cuda.synchronize()
        singles_s += time.perf_counter() - t0
        dw_single = max(dw_single, max_diff(one.w, res.w[k]))
        identical = identical and torch.equal(one.w, res.w[k]) and \
            torch.equal(one.objective, res.objective[k])
    row = {"loss": problem.loss.name, "dtype": cfg.dtype,
           "lams": [float(x) for x in lams], "nodes": problem.num_nodes,
           "edges": problem.graph.num_edges, "warm_iters": warm_iters,
           "final_iters": final_iters, "solve_path_seconds": wall,
           "launches": launches, "max_memory_allocated": peak,
           "lanes_seconds": lanes_s,
           "iterations_per_s_per_lane": final_iters / lanes_s,
           "iterations_per_s_sweep": len(lams) * final_iters / lanes_s,
           "one_lane_solves_seconds": singles_s,
           "one_lane_iterations_per_s":
               (len(lams) if singles is None else len(singles))
               * final_iters / singles_s,
           "max_abs_dw_vs_one_lane_solves": dw_single,
           "bit_identical_to_one_lane_solves": identical,
           "objective_last": res.objective[:, -1].tolist(),
           "diagnostics": {k: v.tolist() for k, v in res.diagnostics.items()}}
    if w_true is not None:
        row["mse_last"] = res.mse[:, -1].tolist()
    require(dw_single <= PATH_TOL,
            f"{variant}: a lane against its one-lane solve {dw_single}")
    for k in dense_lanes:
        one = backends._solve_dense(
            problem.with_lam(float(lams[k])), final_cfg.replace(
                backend="dense", dtype="float32"),
            w0=warm.w, u0=u0_b[k], w_true=w_true)
        dw = max_diff(one.w, res.w[k])
        obj_rel = float(((one.objective - res.objective[k]).abs()
                         / one.objective.abs()).max())
        row.setdefault("dense_lanes", {})[str(k)] = {
            "max_abs_dw": dw, "objective_max_rel": obj_rel}
        require(dw <= SOLVE_TOL and obj_rel <= 1e-4,
                f"{variant} lane {k} vs a dense one-lane solve {dw}, "
                f"{obj_rel}")
    if dense:
        t0 = time.perf_counter()
        ref = solve_path(problem, lams, cfg.replace(backend="dense"),
                         w_true=w_true)
        torch.cuda.synchronize()
        dw, obj_rel = compare(res, ref)
        row.update(dense_path_seconds=time.perf_counter() - t0,
                   max_abs_dw_vs_dense_path=dw,
                   objective_max_rel_vs_dense_path=obj_rel)
        require(dw <= SOLVE_TOL and obj_rel <= 1e-4,
                f"{variant} path vs dense path |dw| {dw}, obj {obj_rel}")
    return row, lane_launches


def phase_path_full_size(torch, dev, big, w_true, others) -> list:
    """``solve_path`` with ``backend="pallas"`` (the fused lanes) at full
    size over PATH_LAMS: the squared loss in float32 (500 warm + 500
    final iterations), against one-lane solves and the dense path's
    sweep, and in bf16 storage; the lasso and logistic instances of
    ``full_size_variants`` in float32 (300 + 300); each against one-lane
    solves, and each lane kernel alone.  (Depths cut to leave the
    script's time to the wide and streamed phases.)
    Returns the kernels' entries."""
    from repro_torch.api import SolverConfig

    t0 = time.perf_counter()
    cfg = SolverConfig(backend="pallas", rho=1.9, metric_every=100,
                       warm_iters=500, final_iters=500)
    runs, entries = [], []
    for problem, truth, run_cfg, dense in (
            (big, w_true, cfg, True),
            (big, w_true, cfg.replace(dtype="bfloat16"), False),
            (*others["lasso"], cfg.replace(warm_iters=300, final_iters=300),
             False),
            (*others["logistic"], cfg.replace(warm_iters=300,
                                              final_iters=300), False)):
        row, launches = path_run(torch, dev, problem, PATH_LAMS, run_cfg,
                                 truth, dense=dense)
        row["kernel"], entry = lane_kernel_entry(
            torch, dev, problem, PATH_LAMS, getattr(torch, run_cfg.dtype),
            launches, run_cfg.rho, run_cfg.metric_every)
        runs.append(row)
        entries.append(entry)
    emit({"phase": "path_full_size", "seconds": time.perf_counter() - t0,
          "runs": runs})
    return entries


def wide_instances(graph, assign, seed: int, n: int = WIDE_N,
                   samples=(33, 3, 8), losses=("squared", "lasso",
                                               "logistic")) -> dict:
    """The three losses at ``n`` features on the full-size graph, drawn
    on the card: squared with 33 samples a node from per-cluster N(0, 1)
    weights, noiseless (more samples than features, as
    ``make_clustered``'s m_i = 5 at n = 2: with fewer, the labeled nodes
    fix only m of w's directions, the rest is flat, and a bf16 run ends
    elsewhere in it: 2.0 of w's scale from dense float32 at n = 32 with
    5 samples, in a probe run); lasso with 3 (the m_i < n regime) from
    those weights with three in four zeroed, noise 0.05; logistic with 8
    and Bernoulli labels of sigmoid(x^T w) (``samples`` overrides the
    three counts, ``losses`` picks).  10% of the nodes labeled.  Returns
    {loss: (Problem, w_true)}."""
    import torch
    from repro_torch.api import Problem
    from repro_torch.core.losses import NodeData

    v, dev = graph.num_nodes, graph.device
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    levels = rng.standard_normal((2, n)).astype(np.float32)
    sparse = levels * (rng.random((2, n)) < 0.25)
    cluster = torch.from_numpy(np.asarray(assign) % 2).to(dev)
    labeled = np.zeros(v, np.float32)
    labeled[rng.choice(v, size=v // 10, replace=False)] = 1.0
    labeled = torch.from_numpy(labeled).to(dev)

    def draw(m, weights):
        w_true = torch.from_numpy(weights).to(dev)[cluster]
        x = torch.randn((v, m, n), generator=gen, device=dev)
        return x, w_true, torch.einsum("vmn,vn->vm", x, w_true)

    m_sq, m_lasso, m_log = samples     # squared: more samples than n
    out = {}
    if "squared" in losses:
        x, w_true, y = draw(m_sq, levels)
        out["squared"] = (Problem.create(graph, NodeData(
            x, y, torch.ones((v, m_sq), device=dev), labeled), 1e-3,
            device=dev), w_true)
    if "lasso" in losses:
        x, w_true, y = draw(m_lasso, sparse)
        y = y + 0.05 * torch.randn(y.shape, generator=gen, device=dev)
        out["lasso"] = (Problem.create(graph, NodeData(
            x, y, torch.ones((v, m_lasso), device=dev), labeled), 1e-2,
            loss="lasso", device=dev, **LASSO_KW), w_true)
    if "logistic" in losses:
        x, w_true, logit = draw(m_log, levels)
        y = (torch.rand(logit.shape, generator=gen, device=dev)
             < torch.sigmoid(logit)).float()
        out["logistic"] = (Problem.create(graph, NodeData(
            x, y, torch.ones((v, m_log), device=dev), labeled), 1e-3,
            loss="logistic", device=dev), w_true)
    return out


def route_seconds(torch, problem, iters: int) -> dict:
    """Seconds of a float32 solve of ``iters`` iterations (one metric
    block, prox set-up included) on the fused route and on the unfused
    route (``fused=False``: the dense engine with the ``tv_prox`` and
    ``batched_affine`` hooks), the route such a problem took on the card
    before the kernel took any width and any sample count."""
    from repro_torch.api import Solver, SolverConfig

    out = {"iterations": iters}
    for route, fused in (("fused", True), ("unfused", False)):
        cfg = SolverConfig(backend="pallas", fused=fused, rho=1.9,
                           num_iters=iters, metric_every=iters,
                           compute_diagnostics=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = Solver(cfg).run(problem)
        torch.cuda.synchronize()
        out[f"{route}_seconds"] = time.perf_counter() - t0
        require(bool(torch.isfinite(result.w).all()),
                f"{route} route result not finite")
        del result
    out["unfused_over_fused"] = out["unfused_seconds"] / out["fused_seconds"]
    return out


def phase_wide_full_size(torch, dev, graph, assign) -> list:
    """The wide variant at full size, on the full-size graph (its layout
    planned once for every solve): a 6-lambda ``solve_path`` of the
    squared instance of ``wide_instances`` at n = WIDE_N through the
    fused lanes (30 + 30 iterations), its first and last lanes against
    one-lane fused solves and its first against a one-lane dense solve;
    then that instance in float32 (1000
    iterations) and bfloat16 (200), lasso and logistic in float32 and
    bfloat16 (20 iterations: the dense backend, which holds each of them
    over its whole budget, takes ~0.35 s and ~1.5 s an iteration here, so
    the script's time allows no more), each against the dense backend over
    its whole budget, the float32 squared one with the float64 yardstick
    (``full_size_solve``'s ``exact``); then both routes' times of a
    ROUTE_ITERS-iteration lasso and logistic solve (``route_seconds``).
    Each solve records the kernel's ms a step beside ``step_cost``'s
    bound, the launches and the peak memory.  Returns the kernels'
    entries."""
    from repro_torch.api import SolverConfig

    t0 = time.perf_counter()
    wide = wide_instances(graph, assign, seed=2, losses=("squared",))
    gen_s = time.perf_counter() - t0
    # the λ path first, before the other instances are drawn: its lanes
    # and the prox set-up of the solve over them hold ~50 GB at their
    # peak, and the solves below fragment the allocator's cache (no
    # certificate: six of them at n = 32 would add ~13 GB each)
    problem, truth = wide["squared"]
    path_cfg = SolverConfig(backend="pallas", rho=1.9, metric_every=10,
                            warm_iters=30, final_iters=30,
                            compute_diagnostics=False)
    # the first and last lanes against one-lane solves: each such solve
    # sets up its own prox (1M 32 x 32 inverses, seconds each)
    ends = (0, len(PATH_LAMS) - 1)
    path, launches = path_run(torch, dev, problem, PATH_LAMS, path_cfg,
                              truth, dense_lanes=(0,), singles=ends)
    torch.cuda.empty_cache()
    path["kernel"], path_entry = lane_kernel_entry(
        torch, dev, problem, PATH_LAMS, torch.float32, launches, 1.9, 10,
        name="fused_pd_step[squared,f32,wide,lanes]")
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    wide.update(wide_instances(graph, assign, seed=2,
                               losses=("lasso", "logistic")))
    gen_s += time.perf_counter() - t1
    fixed = SolverConfig(backend="pallas", rho=1.9, num_iters=1000)
    rows, entries, dense = [], [], {}
    for loss, dt, iters in (
            ("squared", "float32", 1000), ("squared", "bfloat16", 200),
            ("lasso", "float32", 20), ("lasso", "bfloat16", 20),
            ("logistic", "float32", 20), ("logistic", "bfloat16", 20)):
        problem, truth = wide[loss]
        tag = "f32" if dt == "float32" else "bf16"
        # a metric block of 5 iterations where the plain version, which
        # the kernel is held to over one block, takes 0.16 s (lasso) and
        # 1 s (logistic) an iteration
        cfg = fixed.replace(dtype=dt, num_iters=iters,
                            metric_every=100 if loss == "squared" else 5)
        # each solve against the dense backend over its whole budget (a
        # loss's f32 and bf16 solves share one dense solve where their
        # budgets agree); the 1000-iteration float32 one with the float64
        # yardstick
        if dt == "float32":
            dense.clear()
        row, entry = full_size_solve(
            torch, dev, cfg, problem, truth,
            name=f"fused_pd_step[{loss},{tag},wide]", dense_iters=iters,
            dense_cache=dense, exact=(loss == "squared" and dt == "float32"))
        rows.append(row)
        entries.append(entry)
        torch.cuda.empty_cache()
    del dense
    routes = {loss: route_seconds(torch, wide[loss][0], ROUTE_ITERS)
              for loss in ("lasso", "logistic")}
    entries.append(path_entry)
    emit({"phase": "wide_full_size", "seconds": time.perf_counter() - t0,
          "generate_seconds": gen_s, "num_features": WIDE_N, "runs": rows,
          "path": path, "routes": routes})
    del wide
    torch.cuda.empty_cache()
    return entries


def phase_wide_streamed(torch, dev) -> list:
    """The wide variant with its prox parameters read from device memory
    (past the staging plan), on ``make_clustered``'s recipe at 2,000
    nodes: squared and lasso at n = 256 (P / Q alone 256 KB a node) and
    logistic at n = 32 with 2,000 samples a node, float32, 20 iterations
    each against the dense backend's 20.  Returns the kernels'
    entries."""
    from repro_torch.api import SolverConfig

    t0 = time.perf_counter()
    graph, _, _, assign = make_clustered(2000, seed=6, device=dev)
    cases = {**wide_instances(graph, assign, seed=6, n=256,
                              losses=("squared", "lasso")),
             **wide_instances(graph, assign, seed=7, n=32,
                              samples=(5, 3, 2000), losses=("logistic",))}
    # no certificate: its pseudo-inverse at n = 256 is past the sym_pinv
    # kernel's widths, and the plain version's Jacobi takes ~10 s there
    cfg = SolverConfig(backend="pallas", rho=1.9, metric_every=10,
                       num_iters=20, compute_diagnostics=False)
    rows, entries = [], []
    for loss, (problem, truth) in cases.items():
        row, entry = full_size_solve(
            torch, dev, cfg, problem, truth,
            name=f"fused_pd_step[{loss},f32,wide,streamed]", dense_iters=20)
        require(row["variant"].endswith("/wide/streamed"),
                f"{loss}: not the streamed wide variant {row['variant']}")
        rows.append(row)
        entries.append(entry)
    emit({"phase": "wide_streamed", "seconds": time.perf_counter() - t0,
          "runs": rows})
    return entries


def many_samples_instance(torch, dev):
    """Logistic nodes of MANY_SAMPLES samples at n = 2, past the kernel's
    staging plan, on ``make_clustered``'s recipe at MANY_NODES nodes
    (x, y and the mask ~5.2 GB), drawn on the card: Bernoulli labels of
    sigmoid(x^T w) for the per-cluster (2, 2) / (-2, 2) weights, 10% of
    the nodes labeled.  Returns (Problem, w_true)."""
    from repro_torch.api import Problem
    from repro_torch.core.losses import NodeData

    graph, data, w_true, _ = make_clustered(MANY_NODES, seed=5, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((MANY_NODES, MANY_SAMPLES, 2), generator=gen,
                    device=dev)
    logit = torch.einsum("vmn,vn->vm", x, w_true)
    y = (torch.rand(logit.shape, generator=gen, device=dev)
         < torch.sigmoid(logit)).float()
    del logit
    mask = torch.ones((MANY_NODES, MANY_SAMPLES), device=dev)
    return Problem.create(graph, NodeData(x, y, mask, data.labeled_mask),
                          1e-3, loss="logistic", device=dev), w_true


def streamed_alone(torch, dev, problem) -> dict:
    """The streamed register-tile kernel alone on ``problem`` (the
    many-sample instance) in float32 and bfloat16: ms per ``iters=1``
    step, the launches counted and the bound (labeled nodes' prox, and
    every node's: ``step_cost``), at the instance's own labeled nodes
    and with every node labeled (the same tensors, the labeled column one
    wherever a node has samples)."""
    from repro_torch.api import backends
    from repro_torch.kernels import ops

    lt = backends._graph_layout(problem.graph)
    rows = {}
    for dt in ("float32", "bfloat16"):
        args, kw = problem_args(torch, problem, lt, getattr(torch, dt), dev)
        params = args[4]
        every = (params[1] > 0).to(params[0].dtype)
        for share, labeled in (("instance", params[0]), ("all", every)):
            a = args[:4] + ((labeled,) + params[1:],) + args[5:]
            reset_launches()
            ms = cuda_ms(lambda _: ops.pd_step(*a, **kw), reps=20)
            cost = step_cost(a, kw, problem.loss)
            rows[f"{dt}/{share}"] = {
                "ms_per_step": ms,
                "launches": read_launches()["fused_pd_step_variants"],
                "labeled_nodes": cost["prox_nodes"],
                **{k: cost[k] for k in ("bound_ms", "bound_by",
                                        "bound_ms_all_nodes", "bytes_read",
                                        "flops")}}
        del args, params, every, a
        torch.cuda.empty_cache()
    return rows


def phase_many_samples_full_size(torch, dev) -> list:
    """The streamed register-tile variant at full size: logistic nodes of
    MANY_SAMPLES samples (``many_samples_instance``), fused in float32
    and bfloat16, MANY_ITERS iterations each, against the dense backend's
    MANY_ITERS; the kernel alone at the instance's 10% labeled nodes and
    with every node labeled (``streamed_alone``); and a 6-lambda
    ``solve_path`` through the fused lanes (streamed too; 10 + 10
    iterations), each lane against a one-lane fused solve and the first
    against a one-lane dense solve.  The depth is cut to what the
    script's time allows: a step takes the dense backend ~0.6 s here and
    the plain version ~0.4 s.  Then both routes' times of a
    ROUTE_ITERS-iteration solve (``route_seconds``).  Returns the
    kernels' entries."""
    from repro_torch.api import SolverConfig

    t0 = time.perf_counter()
    problem, truth = many_samples_instance(torch, dev)
    gen_s = time.perf_counter() - t0
    cfg = SolverConfig(backend="pallas", rho=1.9, metric_every=10,
                       num_iters=MANY_ITERS)
    rows, entries, dense = [], [], {}
    for dt, tag in (("float32", "f32"), ("bfloat16", "bf16")):
        row, entry = full_size_solve(
            torch, dev, cfg.replace(dtype=dt), problem, truth,
            name=f"fused_pd_step[logistic,{tag},streamed]",
            dense_iters=MANY_ITERS, dense_cache=dense)
        rows.append(row)
        entries.append(entry)
    del dense
    alone = streamed_alone(torch, dev, problem)
    routes = route_seconds(torch, problem, ROUTE_ITERS)
    path_cfg = SolverConfig(backend="pallas", rho=1.9, metric_every=10,
                            warm_iters=10, final_iters=10)
    row, launches = path_run(torch, dev, problem, PATH_LAMS, path_cfg,
                             truth, dense_lanes=(0,),
                             singles=(0, len(PATH_LAMS) - 1))
    row["kernel"], entry = lane_kernel_entry(
        torch, dev, problem, PATH_LAMS, torch.float32, launches, 1.9, 2,
        name="fused_pd_step[logistic,f32,streamed,lanes]")
    entries.append(entry)
    emit({"phase": "many_samples_full_size",
          "seconds": time.perf_counter() - t0, "generate_seconds": gen_s,
          "nodes": MANY_NODES, "samples_per_node": MANY_SAMPLES,
          "data_bytes": sum(t.numel() * t.element_size() for t in (
              problem.data.x, problem.data.y, problem.data.sample_mask)),
          "runs": rows, "kernel_alone": alone, "path": row,
          "routes": routes})
    del problem
    torch.cuda.empty_cache()
    return entries


def phase_path_tol_full_size(torch, dev, big) -> list:
    """The masked tol sweep at full size, ``backend="pallas"`` (the
    unfused hooks: ``tv_prox`` and ``batched_affine`` over the lanes):
    PATH_LAMS, tol 5e-3, metric_every 20, a budget of 1000, under sync
    debug mode "error" (the sweep's one fetch, and the warm tol solve's).
    Per-lane stopping iterations, each stopped lane's last residual <=
    tol, a frozen lane unchanged bit for bit (a sweep cut at its stop
    holds the same state), fewer iterations than L x budget, and the
    first lane to stop against a single tol solve from its start.  Then
    both kernels alone over the lanes.  Returns the kernels' entries."""
    from repro_torch.api import SolverConfig, backends, solve_path, solver
    from repro_torch.engine import default_warm_lam, device_fetch
    from repro_torch.kernels.ref import batched_affine_ref, tv_prox_ref
    from repro_torch.kernels.ridge_prox import batched_affine
    from repro_torch.kernels.tv_prox import tv_prox

    t0 = time.perf_counter()
    cfg = SolverConfig(backend="pallas", rho=1.9, metric_every=20, tol=5e-3,
                       warm_iters=3000, final_iters=1000,
                       compute_diagnostics=False)
    budget, lams = cfg.final_iters, PATH_LAMS
    # warm-up at a tiny budget: handles and workspaces, outside the
    # sync check
    solve_path(big, lams, cfg.replace(warm_iters=20, final_iters=20))
    torch.cuda.synchronize()
    sweep_fetches = []
    real = solver._solve_path_masked

    def counted(*a, **kw):
        before = device_fetch.calls
        out = real(*a, **kw)
        sweep_fetches.append(device_fetch.calls - before)
        return out

    torch.cuda.reset_peak_memory_stats()
    fetches = device_fetch.calls
    reset_launches()
    solver._solve_path_masked = counted
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = solve_path(big, lams, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        solver._solve_path_masked = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    fetched = device_fetch.calls - fetches
    iters = np.asarray(res.diagnostics["iterations"])
    me = cfg.metric_every
    require(sweep_fetches == [1] and fetched == 2,
            f"path tol fetches: sweep {sweep_fetches}, all {fetched}")
    require(bool(((iters > 0) & (iters <= budget) & (iters % me == 0)).all()),
            f"path tol iterations {iters}")
    require(int(iters.sum()) < len(lams) * budget,
            f"path tol: no lane stopped early {iters}")
    resid = res.residual.cpu().numpy()
    for k in range(len(lams)):
        if iters[k] < budget:
            require(resid[k, iters[k] // me - 1] <= cfg.tol,
                    f"lane {k} stopped above tol {resid[k]}")
    # the first lane to stop: frozen bit for bit, and a single tol solve
    # from its start stops with it
    lane = int(np.argmin(iters))
    warm_cfg = cfg.replace(continuation=False, compute_diagnostics=False,
                           record_residual=False, num_iters=cfg.warm_iters)
    warm = backends.solve_pallas(big.with_lam(default_warm_lam(
        float(np.max(lams)))), warm_cfg)
    w0_b, u0_b, params, run = solver._masked_starts(big, lams, cfg, warm)
    cut = solver._masked_sweep_impl(big, lams, w0_b, u0_b, None, params,
                                    cfg.tol, num_iters=int(iters[lane]),
                                    **run)
    frozen = (torch.equal(cut[0][lane], res.w[lane])
              and torch.equal(cut[1][lane], res.u[lane]))
    one = backends._solve_dense(
        big.with_lam(float(lams[lane])), cfg.replace(num_iters=budget),
        w0=w0_b[lane], u0=u0_b[lane], clip_fn=run["clip_fn"],
        affine_fn=run["affine_fn"])
    dw_single = max_diff(one.w, res.w[lane])
    del cut, w0_b, u0_b
    row = {"lams": [float(x) for x in lams], "tol": cfg.tol,
           "metric_every": me, "budget": budget,
           "solve_path_seconds": wall, "iterations": iters.tolist(),
           "lane_iterations_total": int(iters.sum()),
           "blocks": int(res.objective.shape[1]), "fetches": fetched,
           "sweep_fetches": sweep_fetches[0], "launches": launches,
           "max_memory_allocated": peak, "checked_lane": lane,
           "frozen_lane_bit_identical": frozen,
           "single_tol_iterations": one.diagnostics["iterations"],
           "max_abs_dw_vs_single_tol": dw_single,
           "residual_at_stop": [float(resid[k, iters[k] // me - 1])
                                for k in range(len(lams))]}
    require(frozen, f"lane {lane} moved after its stop")
    # the sweep's kernels' runs on the card, the graph's replays
    # included: the sweep alone, counted in a second run (the count's
    # waits would break the first's sync check); a lane launch of each
    # a step, to the last lane's stop
    sweep_ex = {}

    def counted_sweep(*a, **kw):
        with device_executions(torch, sweep_ex):
            return real_sweep(*a, **kw)

    real_sweep = solver._masked_sweep_impl
    solver._masked_sweep_impl = counted_sweep
    try:
        again = solve_path(big, lams, cfg)
    finally:
        solver._masked_sweep_impl = real_sweep
    steps = row["blocks"] * me
    row.update(sweep_device_executions=sweep_ex, sweep_steps=steps)
    require(torch.equal(again.w, res.w)
            and sweep_ex["tv_prox"] == steps
            and sweep_ex["batched_affine"] == steps,
            f"path tol sweep executions {sweep_ex}, {steps} steps")
    del again
    require(one.diagnostics["iterations"] == int(iters[lane])
            and dw_single <= SOLVE_TOL,
            f"lane {lane} against its single tol solve {row}")

    # each kernel alone over the lanes at the sweep's shapes
    g, n, e = big.graph, big.num_features, big.graph.num_edges
    lam_col = backends.lane_values(lams, dev)[:, None]
    bnd = (lam_col * g.weights).contiguous()                  # (L, E)
    u = torch.stack([box_draw(bnd[k], n, seed=2 + k)
                     for k in range(len(lams))])
    tv_err = max_diff(tv_prox(u, bnd), tv_prox_ref(u, bnd))
    flat_u, flat_b = u.reshape(-1, n), bnd.reshape(-1, 1)
    tv_cost = bound(4 * (u.numel() + bnd.numel()), 4 * u.numel(),
                    2 * u.numel())
    tv = {"shape": list(u.shape), "max_abs_err": tv_err,
          "ms": cuda_ms(lambda _: tv_prox(u, bnd), reps=50),
          "ms_one_lane_launches": cuda_ms(lambda _: [
              tv_prox(u[k], bnd[k]) for k in range(len(lams))], reps=50),
          "plain_ms": cuda_ms(lambda _: tv_prox_ref(u, bnd), reps=20),
          "library_ms": cuda_ms(lambda _: torch.clamp(flat_u, -flat_b,
                                                      flat_b), reps=50),
          **tv_cost}
    del u, flat_u
    p = big.loss.prox_setup(big.data, g.primal_stepsizes())["p"]
    v = 2.0 * torch.randn((len(lams), big.num_nodes, n), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
    affine_err = max_diff(batched_affine(p, v), batched_affine_ref(p, v))
    affine_cost = bound(4 * (p.numel() + v.numel()), 4 * v.numel(),
                        2 * p.numel() * len(lams))
    affine = {"shape": list(v.shape), "p_shape": list(p.shape),
              "max_abs_err": affine_err,
              "ms": cuda_ms(lambda _: batched_affine(p, v), reps=100),
              "ms_one_lane_launches": cuda_ms(lambda _: [
                  batched_affine(p, v[k]) for k in range(len(lams))],
                  reps=100),
              "plain_ms": cuda_ms(lambda _: batched_affine_ref(p, v),
                                  reps=20),
              "library_ms": cuda_ms(lambda _: torch.matmul(p, v[..., None]),
                                    reps=20),
              **affine_cost}
    del v
    torch.cuda.empty_cache()
    emit({"phase": "path_tol_full_size",
          "seconds": time.perf_counter() - t0, **row, "tv_prox": tv,
          "batched_affine": affine})
    require(tv_err == 0.0, f"tv_prox lanes at full size |d| = {tv_err}")
    require(affine_err <= AFFINE_TOL,
            f"batched_affine lanes at full size |d| = {affine_err}")
    lane = launches["lanes"]
    # launches: the wrappers' (the sweep's block 0); device_executions:
    # the kernels' runs over the sweep, the graph's replays included
    return [dict(KERNELS["tv_prox[lanes]"],
                 launches=lane["tv_prox"].get("float32", 0),
                 device_executions=sweep_ex["tv_prox"],
                 max_abs_err=tv_err, ms=tv["ms"], plain_ms=tv["plain_ms"],
                 bound_ms=tv["bound_ms"], bound_by=tv["bound_by"],
                 library_ms=tv["library_ms"]),
            dict(KERNELS["batched_affine[lanes,shared P]"],
                 launches=lane["batched_affine"].get("shared", 0),
                 device_executions=sweep_ex["batched_affine"],
                 max_abs_err=affine_err, ms=affine["ms"],
                 plain_ms=affine["plain_ms"], bound_ms=affine["bound_ms"],
                 bound_by=affine["bound_by"],
                 library_ms=affine["library_ms"])]


def cluster_data(assign, seed: int, device):
    """``make_clustered``'s data recipe on the same clusters, another
    draw: n = 2, m_i = 5, 10% labeled, per-cluster (2,2) / (-2,2)."""
    import torch
    from repro_torch.core.losses import NodeData

    v = len(assign)
    rng = np.random.default_rng(seed)
    w_true = np.where(assign[:, None] % 2 == 0, [2.0, 2.0],
                      [-2.0, 2.0]).astype(np.float32)
    x = rng.standard_normal((v, 5, 2)).astype(np.float32)
    y = np.einsum("vmn,vn->vm", x, w_true)
    labeled = np.zeros(v, np.float32)
    labeled[rng.choice(v, size=max(v // 10, 10), replace=False)] = 1.0
    return NodeData(x=torch.from_numpy(x), y=torch.from_numpy(y),
                    sample_mask=torch.ones((v, 5)),
                    labeled_mask=torch.from_numpy(labeled)).to(device)


def phase_many_full_size(torch, dev, graph, assign) -> list:
    """``solve_many`` of four problems on the full-size graph, two on its
    weights and two on its weights x2 (two structures of one shape), each
    with its own data draw and lambda, ``backend="pallas"`` (the unfused
    hooks over the batch: ``batched_affine`` with one P per problem):
    a fixed budget, each problem within 1e-4 of its sequential
    ``Solver.run`` on the card, and a tol run (batch-granular: one
    shared iteration count, the one a probe's batch residuals name, no
    earlier than any problem's own tol solve; each problem within 1e-4
    of its sequential solve of that many iterations, and within 5e-3 of
    its sequential tol solve where that stops with the batch, as
    ``tests/test_serving_batch.py``).  Then
    ``batched_affine`` alone over the batch.  Returns its entry."""
    import dataclasses

    from repro_torch.api import Problem, Solver, SolverConfig, backends
    from repro_torch.api import solve_many
    from repro_torch.kernels.ref import batched_affine_ref
    from repro_torch.kernels.ridge_prox import batched_affine

    t0 = time.perf_counter()
    lt = backends._graph_layout(graph)
    # the planner's order depends on the edges alone: the x2 graph's
    # layout is the first's with its weights doubled (no second planning)
    twice = dataclasses.replace(
        graph, weights=graph.weights * 2.0,
        layout=dataclasses.replace(lt, weights=lt.weights * 2.0))
    lams = (1e-3, 2e-3, 1e-3, 5e-4)
    problems = [Problem.create(g, cluster_data(assign, 10 + k, dev), lam,
                               device=dev)
                for k, (g, lam) in enumerate(zip((graph, graph, twice,
                                                  twice), lams))]
    cfg = SolverConfig(backend="pallas", rho=1.9, metric_every=100,
                       num_iters=1000)
    # the tol run's tolerance from a probe that never stops (tol 0): the
    # batch's residual after block 10 of 50, so the tol run must stop
    # after the first block whose batch max is at or below it
    tol_cfg = cfg.replace(metric_every=20, tol=0.0, record_residual=True)
    probe = solve_many(problems, tol_cfg)
    trace = torch.stack([r.residual for r in probe]).amax(0).cpu().numpy()
    tol = float(trace[9])
    expected = (int(np.argmax(trace <= tol)) + 1) * tol_cfg.metric_every
    rows = {"tol_probe": {"batch_residuals": trace.tolist(), "tol": tol,
                          "expected_iterations": expected}}
    for label, run_cfg in (("fixed", cfg), ("tol", tol_cfg.replace(tol=tol))):
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        reset_launches()
        ran = {}
        with device_executions(torch, ran):
            t1 = time.perf_counter()
            got = solve_many(problems, run_cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        t1 = time.perf_counter()
        seq = [Solver(run_cfg).run(p) for p in problems]
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t1
        dws = [max_diff(g.w, s.w) for g, s in zip(got, seq)]
        row = {"lams": list(lams), "num_iters": run_cfg.num_iters,
               "tol": run_cfg.tol, "solve_seconds": wall,
               "sequential_seconds": seq_s, "launches": launches,
               "max_memory_allocated": peak, "max_abs_dw_vs_sequential": dws}
        require(all(bool(torch.isfinite(g.w).all()) for g in got),
                f"solve_many {label} w")
        if run_cfg.tol is None:
            its = run_cfg.num_iters
            obj_rel = max(compare(g, s)[1] for g, s in zip(got, seq))
            row["objective_max_rel_vs_sequential"] = obj_rel
            require(max(dws) <= SOLVE_TOL and obj_rel <= 1e-4,
                    f"solve_many vs sequential {row}")
        else:
            shared = {g.diagnostics["iterations"] for g in got}
            require(len(shared) == 1, f"solve_many tol iterations {shared}")
            its = shared.pop()
            row["iterations"] = its
            row["sequential_iterations"] = [s.diagnostics["iterations"]
                                            for s in seq]
            require(its == expected, f"solve_many tol stopped at {its}, "
                    f"not {expected}")
            require(its >= max(row["sequential_iterations"]),
                    f"solve_many stopped before its slowest member {row}")
            require(all(float(g.residual[-1]) <= run_cfg.tol for g in got),
                    "solve_many residual above tol")
            # batch-granular: each problem ran the shared count, so it is
            # its sequential solve of that many iterations (1e-4); from a
            # problem's own, earlier stop its w is further on (reported;
            # the reference's 5e-3 holds where the stops coincide)
            at = [Solver(run_cfg.replace(tol=None, num_iters=its)).run(p)
                  for p in problems]
            row["max_abs_dw_vs_sequential_at_shared_count"] = [
                max_diff(g.w, a.w) for g, a in zip(got, at)]
            require(max(row["max_abs_dw_vs_sequential_at_shared_count"])
                    <= SOLVE_TOL, f"solve_many tol vs sequential {row}")
            require(all(d <= 5e-3 for d, s in zip(dws, seq)
                        if s.diagnostics["iterations"] == its),
                    f"solve_many tol vs sequential tol solves {row}")
        lanes = launches["lanes"]
        row["iterations_per_s_per_problem"] = its / wall
        row["device_executions"] = ran
        # a lane launch of each kernel a step (in a tol batch the
        # wrappers launch block 0 and the graph's replays run the rest),
        # none after a tol batch's stop
        steps = its
        require(ran["batched_affine"] == steps and ran["tv_prox"] == steps
                and lanes["batched_affine"].get("per_lane", 0)
                == (steps if run_cfg.tol is None else tol_cfg.metric_every),
                f"solve_many {label} launches {launches}, ran {ran}, "
                f"{steps} steps")
        rows[label] = row
    affine_launches = rows["fixed"]["launches"]["lanes"]["batched_affine"][
        "per_lane"]
    # batched_affine alone over the batch: one P per problem
    p = torch.stack([p_.loss.prox_setup(
        p_.data, p_.graph.primal_stepsizes())["p"] for p_ in problems])
    v = 2.0 * torch.randn(p.shape[:-1], device=dev,
                          generator=torch.Generator(device=dev).manual_seed(4))
    err = max_diff(batched_affine(p, v), batched_affine_ref(p, v))
    cost = bound(4 * (p.numel() + v.numel()), 4 * v.numel(), 2 * p.numel())
    affine = {"shape": list(v.shape), "p_shape": list(p.shape),
              "max_abs_err": err,
              "ms": cuda_ms(lambda _: batched_affine(p, v), reps=100),
              "ms_one_lane_launches": cuda_ms(lambda _: [
                  batched_affine(p[k], v[k]) for k in range(len(lams))],
                  reps=100),
              "plain_ms": cuda_ms(lambda _: batched_affine_ref(p, v),
                                  reps=20),
              "library_ms": cuda_ms(lambda _: torch.matmul(p, v[..., None]),
                                    reps=20),
              **cost}
    del p, v, problems
    torch.cuda.empty_cache()
    emit({"phase": "many_full_size", "seconds": time.perf_counter() - t0,
          "nodes": graph.num_nodes, "edges": graph.num_edges, **rows,
          "batched_affine": affine})
    require(err <= AFFINE_TOL, f"batched_affine per-lane P |d| = {err}")
    return [dict(KERNELS["batched_affine[lanes,per-lane P]"],
                 launches=affine_launches, max_abs_err=err, ms=affine["ms"],
                 plain_ms=affine["plain_ms"], bound_ms=affine["bound_ms"],
                 bound_by=affine["bound_by"],
                 library_ms=affine["library_ms"])]


def warm_start(problem, w, u):
    """A warm start as the service makes it: copies of the cached state,
    the duals re-projected onto the problem's lambda box."""
    return w.clone(), problem.regularizer.project_dual(
        u.clone(), problem.graph, problem.lam)


def request(torch, fn, strict: bool = True) -> tuple[object, dict]:
    """One service request under sync debug mode "error" (unless not
    ``strict``: a plan miss of a fused service plans its layout on the
    host): its answer, its host reads (the tol solve's ``device_fetch``
    and the answer's read, ``_to_host``), the kernels' launches and their
    runs on the card (the tol engine's replays included)."""
    from repro_torch.engine import device_fetch
    from repro_torch.serving.service import _to_host

    torch.cuda.synchronize()
    before = device_fetch.calls + _to_host.reads
    reset_launches()
    executions = {}
    with device_executions(torch, executions):
        torch.cuda.set_sync_debug_mode("error" if strict else 0)
        try:
            resp = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return resp, {"fetches": device_fetch.calls + _to_host.reads - before,
                  "launches": read_launches(),
                  "device_executions": executions}


def response_row(resp, io: dict | None = None) -> dict:
    row = {k: getattr(resp, k) for k in (
        "iterations", "warm", "cache_hit", "compiled", "meets_sla",
        "residual", "objective", "seconds", "solve_seconds",
        "compile_seconds", "batch_width", "queue_wait")}
    return {**row, **(io or {})}


def pinv_cost(n: int, matrices: int) -> dict:
    """The least time on an H100 for ``matrices`` n x n pseudo-inverses
    by the kernel's Jacobi: each matrix read and written once, against
    its sweeps' float operations (a round rotates n / 2 pairs over the
    columns of A and V and the rows of A, 6 operations an entry pair; n
    - 1 rounds a sweep) and the product V diag(1 / lambda) V^T."""
    from repro_torch.engine.step import jacobi_sweeps

    rounds = n - 1 + n % 2
    per_sweep = rounds * (n // 2) * n * 3 * 6
    flops = matrices * (jacobi_sweeps(n) * per_sweep + 3 * n ** 3)
    return bound(4 * n * n * matrices, 4 * n * n * matrices, flops)


def certificate_cost(torch, dev) -> list:
    """The optimality-gap certificate (``engine.step.optimality_gap``) on
    the card at n = 2, 16, 32 and 64 features on 1000 nodes and n = 16 on
    100,000: its pseudo-inverse, the ``sym_pinv`` kernel, against its
    plain version (``engine.step.sym_pinv``, Jacobi in tensor ops; the
    kernel within 1e-4 of the float64 pinv relative to each matrix's
    scale, or twice the plain version's own distance from it) and
    ``torch.linalg.pinv`` (which checks its status on the host), CUDA-event
    ms of each and the kernel's bound; the certificate's ms and host wall
    ms a call, and one certificate under ``set_sync_debug_mode("error")``
    (no host read); and at the full-size solve's shape.  Returns (rows, the kernel's entry for the kernels'
    line: at the main path's shapes, n = 2 on FULL_NODES nodes, the
    full-size solve's certificate)."""
    from repro_torch.api import Problem
    from repro_torch.core.graph import chain_graph
    from repro_torch.core.losses import NodeData
    from repro_torch.engine.step import (jacobi_sweeps, optimality_gap,
                                         sym_pinv)
    from repro_torch.kernels import sym_pinv as kernel

    rows, entry = [], None
    for v, n in ((1000, 2), (1000, 16), (1000, 32), (1000, 64),
                 (100_000, 16), (FULL_NODES, 2)):
        rng = np.random.default_rng(v + n)
        x = rng.standard_normal((v, n + 4, n)).astype(np.float32)
        y = rng.standard_normal((v, n + 4)).astype(np.float32)
        problem = Problem.create(chain_graph(rng, v, device=dev), NodeData(
            x=torch.from_numpy(x), y=torch.from_numpy(y),
            sample_mask=torch.ones((v, n + 4)),
            labeled_mask=torch.ones(v)).to(dev), lam=1e-2)
        w = torch.randn((v, n), device=dev)
        u = 0.01 * torch.randn((v - 1, n), device=dev)
        q = (torch.einsum("vmn,vmk->vnk", problem.data.x, problem.data.x)
             / (n + 4)).contiguous()
        sweeps = jacobi_sweeps(n)
        got = kernel.sym_pinv(q, sweeps=sweeps)
        want = sym_pinv(q)
        lib = torch.linalg.pinv(q)
        # the float64 yardstick on the host (cuSOLVER's batched
        # eigensolver refuses a batch of a million)
        exact = torch.linalg.pinv(
            q.double().cpu(), rtol=10 * n * float(np.finfo(np.float32).eps),
            hermitian=True)
        scale = exact.abs().amax((1, 2))

        def dist(a, b):
            return float(((a.double().cpu() - b.double().cpu()).abs()
                          .amax((1, 2)) / scale).max())
        err, err_lib = dist(got, want), dist(got, lib)
        err_exact, plain_exact = dist(got, exact), dist(want, exact)
        optimality_gap(problem, w, u)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t1 = time.perf_counter()
            optimality_gap(problem, w, u)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
        finally:
            torch.cuda.set_sync_debug_mode(0)
        row = {"nodes": v, "features": n, "sweeps": sweeps,
               "kernel_max_rel_err_vs_plain": err,
               "kernel_max_rel_err_vs_pinv": err_lib,
               "kernel_max_rel_err_vs_f64": err_exact,
               "plain_max_rel_err_vs_f64": plain_exact,
               "kernel_ms": cuda_ms(lambda _: kernel.sym_pinv(
                   q, sweeps=sweeps), reps=10),
               "plain_ms": cuda_ms(lambda _: sym_pinv(q), reps=3),
               "pinv_ms": cuda_ms(lambda _: torch.linalg.pinv(q), reps=3),
               **pinv_cost(n, v),
               "ms": cuda_ms(lambda _: optimality_gap(problem, w, u),
                             reps=3),
               "wall_ms": wall * 1e3}
        rows.append(row)
        require(err_exact <= max(1e-4, 2.0 * plain_exact),
                f"sym_pinv kernel vs plain version {row}")
        if (v, n) == (FULL_NODES, 2):
            entry = dict(KERNELS["sym_pinv"], max_abs_err=err,
                         ms=row["kernel_ms"], plain_ms=row["plain_ms"],
                         bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                         library_ms=row["pinv_ms"])
        del problem, q, w, u, got, want, lib, exact
    return rows, entry


def phase_serving_s5(torch, dev) -> dict:
    """The solve service (``repro_torch.serving``) on the card: a dense
    ``DEFAULT_CONFIG`` service and a ``pallas`` ``fused=True`` one on the
    §5 instance at lambda 1e-2.  Each answers a cold request, a warm one
    after a ``DataDelta`` (a seeded 5% drift from ``synthetic_stream``),
    a lambda retarget and an ``EdgePatch`` (the stream's churn: one edge
    dropped, one added), each equal bit for bit to the port's own
    ``Solver.run`` from the same state and meeting its SLA, with at most
    two host reads a request under sync debug mode "error" (three for
    a compiled one, whose solve runs twice for the compile split); then
    ``solve_path`` (against ``api.solve_path``), and ``solve_batch`` and
    a ``ServingQueue`` drain over four sessions of the serving tests'
    chain problems (against ``solve_many``: the lane kernels on the
    ``pallas`` service).  A fused service's plan misses (its cold and
    patch requests) plan the structure's layout on the host, so they run
    outside the sync check.  Then the certificate's cost
    (``certificate_cost``).  Returns the ``sym_pinv`` kernel's entry for
    the kernels' line."""
    import dataclasses

    from repro_torch.api import Problem, Solver, solve_many, solve_path
    from repro_torch.core.graph import chain_graph
    from repro_torch.core.losses import NodeData
    from repro_torch.core.partition import transfer_edge_duals
    from repro_torch.data.synthetic import make_sbm_regression
    from repro_torch.serving import (DEFAULT_CONFIG, ServingQueue,
                                     SolveService, solve_batch,
                                     synthetic_stream)
    from repro_torch.serving.service import _apply_delta, _apply_patch

    t0 = time.perf_counter()
    ds = make_sbm_regression(seed=0)
    s5 = Problem.create(ds.graph, ds.data, 1e-2)
    drift, churn = synthetic_stream(np.random.default_rng(5), s5.data,
                                    s5.graph, num_steps=2,
                                    drift_fraction=0.05, drift_scale=0.1,
                                    churn_every=2)

    def chain(seed):
        rng = np.random.default_rng(seed)
        v = 24
        w_true = np.where(np.arange(v)[:, None] < v // 2, 1.0, -1.0)
        x = rng.standard_normal((v, 4, 2)).astype(np.float32)
        y = np.einsum("vmn,vn->vm", x, np.broadcast_to(w_true, (v, 2)))
        y = (y + 0.01 * rng.standard_normal(y.shape)).astype(np.float32)
        return Problem.create(chain_graph(rng, v, device=dev), NodeData(
            x=torch.from_numpy(x), y=torch.from_numpy(y),
            sample_mask=torch.ones((v, 4)),
            labeled_mask=torch.ones(v)).to(dev), lam=5e-2)

    rows = {}
    for name, cfg in (("dense", DEFAULT_CONFIG),
                      ("fused", DEFAULT_CONFIG.replace(backend="pallas",
                                                       fused=True))):
        svc = SolveService(config=cfg)
        sid = svc.create_session("t", s5)
        solver = Solver(cfg)
        answers, same = [], []
        # a plan miss of the fused service plans its layout on the host:
        # its cold and patch requests run outside the sync check
        cold, io = request(torch, lambda: svc.solve(sid),
                           strict=name == "dense")
        same.append(torch.equal(cold.w, solver.run(s5).w))
        answers.append(response_row(cold, io))
        prev, problem = cold, s5
        for step, update in (("delta", dict(delta=drift.delta)),
                             ("lam", dict(lam=5e-3)),
                             ("patch", dict(patch=churn.patch))):
            u_prev = svc.session(sid).u
            svc.update_session(sid, **update)
            if step == "delta":
                problem = dataclasses.replace(
                    problem, data=_apply_delta(problem.data, drift.delta))
            elif step == "lam":
                problem = problem.with_lam(5e-3)
            else:
                graph = _apply_patch(problem.graph, churn.patch)
                u_prev = torch.from_numpy(transfer_edge_duals(
                    problem.graph, graph, u_prev)).to(dev)
                problem = dataclasses.replace(problem, graph=graph)
            resp, io = request(torch, lambda: svc.solve(sid),
                               strict=not (step == "patch"
                                           and name == "fused"))
            w0, u0 = warm_start(problem, prev.w, u_prev)
            same.append(torch.equal(resp.w, solver.run(problem, w0=w0,
                                                       u0=u0).w))
            answers.append(dict(response_row(resp, io), step=step))
            prev = resp
        lams = [2e-2, 1e-2, 5e-3]
        path = svc.solve_path(sid, lams)
        want = solve_path(problem, lams, cfg.replace(
            tol=None, record_residual=True, continuation=False))
        same.append(all(torch.equal(r.w, want.w[i])
                        for i, r in enumerate(path)))
        # four chain sessions: batched cold, then a queue's warm drain
        chains = [chain(k) for k in range(4)]
        sids = [svc.create_session(f"c{k % 2}", p)
                for k, p in enumerate(chains)]
        reset_launches()
        batch = solve_batch(svc, sids)
        torch.cuda.synchronize()
        batch_launches = read_launches()
        want = solve_many(chains, cfg)
        same.append(all(torch.equal(r.w, m.w) for r, m in zip(batch, want)))
        starts = [warm_start(p, svc.session(x).w, svc.session(x).u)
                  for p, x in zip(chains, sids)]
        q = ServingQueue(svc, max_batch=4, max_wait_requests=100)
        tickets = [q.submit(x) for x in sids]
        want = solve_many(chains, cfg, w0s=[w for w, _ in starts],
                          u0s=[u for _, u in starts])
        same.append(all(t.done and torch.equal(t.response.w, m.w)
                        for t, m in zip(tickets, want)))
        rows[name] = {
            "requests": answers, "bit_identical_to_solver": same,
            "path": [response_row(r) for r in path],
            "batch": [response_row(r) for r in batch],
            "batch_launches": batch_launches,
            "queue": [response_row(t.response) for t in tickets],
            "queue_stats": q.stats(), "summary": svc.summary()}
        require(all(same), f"serving §5 {name}: answers differ from the "
                f"solver {same}")
        # a compiled request runs its solve twice (the compile split)
        require(all(a["meets_sla"] and a["fetches"] <= 2 + a["compiled"]
                    for a in answers), f"serving §5 {name}: {answers}")
        require(answers[1]["warm"] and answers[1]["cache_hit"]
                and answers[1]["iterations"] < answers[0]["iterations"],
                f"serving §5 {name}: warm answer {answers[1]}")
        require(all(r["meets_sla"] for r in rows[name]["batch"]
                    + rows[name]["queue"]), f"serving §5 {name} batch")
        if name == "fused":
            # the wrapper launches block 0; the kernel runs once a block
            # to the stop
            ran = answers[1]["device_executions"]["fused_pd_step"]
            require(not answers[1]["compiled"]
                    and answers[1]["launches"]["fused_pd_step"] == 1
                    and ran == answers[1]["iterations"] // cfg.metric_every,
                    f"serving §5 fused warm launches {answers[1]}")
            lanes = batch_launches["lanes"]
            require(lanes["tv_prox"].get("float32", 0) > 0
                    and lanes["batched_affine"].get("per_lane", 0) > 0,
                    f"serving §5 solve_batch lane launches {batch_launches}")
    cert, cert_entry = certificate_cost(torch, dev)
    emit({"phase": "serving_s5", "seconds": time.perf_counter() - t0,
          "certificate": cert,
          "instance": "make_sbm_regression(seed=0), lam 1e-2; chains of 24",
          "config": {"num_iters": DEFAULT_CONFIG.num_iters,
                     "metric_every": DEFAULT_CONFIG.metric_every,
                     "rho": DEFAULT_CONFIG.rho, "tol": DEFAULT_CONFIG.tol},
          **rows})
    return cert_entry


def phase_serving_full_size(torch, big, assign, full_tol: float,
                            plan_seconds: float) -> None:
    """The solve service at full size, on the shared 1M graph (layout
    already planned): a fused squared service (``num_iters=6000``,
    ``metric_every=25``, ``rho=1.9``, tol from ``full_size_tol``'s
    probe). A cold request, then a warm one after a seeded 1% data-only
    drift (``synthetic_stream``), each equal bit for bit to ``Solver.run``
    from the same state, with two host reads under sync debug mode "error"
    (three when compiled); a second tenant on the same structure, a plan
    hit with no planning; ``save_plans``, a fresh service after clearing
    the RCM memo, ``load_plans`` and its first answer on a new graph object
    of the structure (no planning, equal to the first service's cold
    answer); ``solve_batch`` of four warm sessions against
    ``solve_many``; each request's kernel runs on the card counted,
    the tol engine's replays included.  Then a dense service's cold and warm requests at a
    budget cut to 2000 (``DEFAULT_CONFIG``'s 6000
    would not change a stopped solve): the warm latency against its
    stopping iterations x the dense step.  No edge patch: each re-plans
    a 1M graph (~50 s)."""
    import dataclasses
    import shutil

    from repro_torch.api import Problem, Solver, backends, solve_many
    from repro_torch.core import partition
    from repro_torch.serving import (DEFAULT_CONFIG, SolveService,
                                     solve_batch, synthetic_stream)
    from repro_torch.serving.service import _apply_delta

    t0 = time.perf_counter()
    dev = big.device
    cfg = DEFAULT_CONFIG.replace(backend="pallas", fused=True,
                                 num_iters=6000, metric_every=25, rho=1.9,
                                 tol=full_tol)
    plans = []
    real_plan = backends.plan_edge_blocks

    def counted_plan(*a, **kw):
        plans.append(1)
        return real_plan(*a, **kw)

    backends.plan_edge_blocks = counted_plan
    rcm = []
    real_rcm = partition.rcm_order

    def counted_rcm(*a, **kw):
        rcm.append(1)
        return real_rcm(*a, **kw)

    partition.rcm_order = counted_rcm
    try:
        svc = SolveService(config=cfg)
        sid = svc.create_session("a", big)
        cold, io = request(torch, lambda: svc.solve(sid))
        solver = Solver(cfg)
        same = {"cold": torch.equal(cold.w, solver.run(big).w)}
        rows = {"cold": response_row(cold, io)}
        t1 = time.perf_counter()
        (ev,) = synthetic_stream(np.random.default_rng(11), big.data,
                                 big.graph, num_steps=1,
                                 drift_fraction=0.01, drift_scale=0.1)
        rows["drift_seconds"] = time.perf_counter() - t1
        u_cold = svc.session(sid).u
        svc.update_session(sid, delta=ev.delta)
        drifted = dataclasses.replace(big, data=_apply_delta(big.data,
                                                             ev.delta))
        warm, io = request(torch, lambda: svc.solve(sid))
        w0, u0 = warm_start(drifted, cold.w, u_cold)
        same["warm"] = torch.equal(warm.w, solver.run(drifted, w0=w0,
                                                      u0=u0).w)
        rows["warm"] = response_row(warm, io)
        # a second tenant on the same structure: a plan hit, no planning
        other = Problem.create(big.graph, cluster_data(assign, 21, dev),
                               1e-3)
        before = (len(plans), len(rcm), svc.plans.misses)
        sid_b = svc.create_session("b", other)
        second, io = request(torch, lambda: svc.solve(sid_b))
        rows["second_tenant"] = dict(response_row(second, io),
                                     plannings=len(plans) - before[0],
                                     plan_misses=svc.plans.misses
                                     - before[2])
        # once a block to the stop, in each run (two when compiled)
        require(io["device_executions"]["fused_pd_step"]
                == (1 + second.compiled) * second.iterations
                // cfg.metric_every,
                f"serving 1M second tenant's kernels {io}")
        require(second.cache_hit and len(plans) == before[0]
                and len(rcm) == before[1]
                and svc.plans.misses == before[2],
                f"serving 1M second tenant planned {rows['second_tenant']}")
        # persisted plans: a restarted service plans nothing
        path = ROOT / "build" / "serving_plans"
        shutil.rmtree(path, ignore_errors=True)
        t1 = time.perf_counter()
        saved = svc.save_plans(str(path))
        save_s = time.perf_counter() - t1
        # a restart: no RCM order in memory, a graph object of the
        # structure that carries no layout and is in no layout cache
        partition._RCM_CACHE.clear()
        fresh = SolveService(config=cfg)
        t1 = time.perf_counter()
        loaded = fresh.load_plans(str(path))
        load_s = time.perf_counter() - t1
        restarted = Problem.create(dataclasses.replace(big.graph,
                                                       layout=None),
                                   big.data, 1e-3)
        before = (len(plans), len(rcm))
        t1 = time.perf_counter()
        sid_r = fresh.create_session("a", restarted)
        hash_s = time.perf_counter() - t1
        first, io = request(torch, lambda: fresh.solve(sid_r))
        same["restored"] = torch.equal(first.w, cold.w)
        rows["restored"] = dict(
            response_row(first, io), saved=saved, loaded=loaded,
            save_seconds=save_s, load_plans_seconds=load_s,
            structure_hash_seconds=hash_s,
            planning_seconds_earlier=plan_seconds,
            plannings=len(plans) - before[0],
            rcm_orders=len(rcm) - before[1])
        shutil.rmtree(path, ignore_errors=True)
        require(first.cache_hit and first.compiled
                and len(plans) == before[0] and len(rcm) == before[1],
                f"serving 1M restored service planned {rows['restored']}")
        del fresh, restarted
        # four warm sessions, drifted, in one batched solve
        sids = [sid, sid_b]
        for k in range(2):
            p = Problem.create(big.graph, cluster_data(assign, 31 + k, dev),
                               1e-3)
            sids.append(svc.create_session(f"c{k}", p))
            svc.solve(sids[-1])
        states = []
        for k, s_ in enumerate(sids):
            (ev_k,) = synthetic_stream(np.random.default_rng(40 + k),
                                       svc.session(s_).problem.data,
                                       big.graph, num_steps=1,
                                       drift_fraction=0.01, drift_scale=0.1)
            sess = svc.session(s_)
            states.append((sess.w, sess.u))
            svc.update_session(s_, delta=ev_k.delta)
        problems = [svc.session(s_).problem for s_ in sids]
        reset_launches()
        batch_ex = {}
        t1 = time.perf_counter()
        with device_executions(torch, batch_ex):
            batch = solve_batch(svc, sids)
        batch_s = time.perf_counter() - t1
        batch_launches = read_launches()
        starts = [warm_start(p, w, u) for p, (w, u) in zip(problems,
                                                            states)]
        want = solve_many(problems, cfg, w0s=[w for w, _ in starts],
                          u0s=[u for _, u in starts])
        same["batch"] = all(torch.equal(r.w, m.w)
                            for r, m in zip(batch, want))
        rows["batch"] = {"answers": [response_row(r) for r in batch],
                         "seconds": batch_s,
                         "launches": batch_launches,
                         "device_executions": batch_ex}
        # a lane launch of each kernel a step, in each run of the batch
        # (two when compiled: the split re-runs it)
        runs = 2 if batch[0].compiled else 1
        require(batch_ex["tv_prox"] == batch_ex["batched_affine"]
                == runs * batch[0].iterations,
                f"serving 1M solve_batch kernels {rows['batch']}")
        del batch, want, starts, states, problems
        for s_ in sids:
            svc.close(s_)
        rows["summary"] = svc.summary()
        del svc
        torch.cuda.empty_cache()
        # a dense service's pair at a cut budget
        dense_cfg = DEFAULT_CONFIG.replace(num_iters=2000, tol=full_tol)
        dsvc = SolveService(config=dense_cfg)
        dsid = dsvc.create_session("d", big)
        dcold, io = request(torch, lambda: dsvc.solve(dsid))
        rows["dense_cold"] = response_row(dcold, io)
        u_cold = dsvc.session(dsid).u
        dsvc.update_session(dsid, delta=ev.delta)
        dwarm, io = request(torch, lambda: dsvc.solve(dsid))
        w0, u0 = warm_start(drifted, dcold.w, u_cold)
        same["dense_warm"] = torch.equal(
            dwarm.w, Solver(dense_cfg).run(drifted, w0=w0, u0=u0).w)
        step_ms = 1e3 * dcold.solve_seconds / max(dcold.iterations, 1)
        rows["dense_warm"] = dict(
            response_row(dwarm, io), budget=dense_cfg.num_iters,
            budget_cut="2000 of DEFAULT_CONFIG's 6000",
            dense_step_ms=step_ms,
            iterations_x_step_seconds=dwarm.iterations * step_ms / 1e3)
    finally:
        backends.plan_edge_blocks = real_plan
        partition.rcm_order = real_rcm
    emit({"phase": "serving_full_size", "seconds": time.perf_counter() - t0,
          "nodes": big.num_nodes, "edges": big.graph.num_edges,
          "config": {"num_iters": cfg.num_iters,
                     "metric_every": cfg.metric_every, "rho": cfg.rho,
                     "tol": cfg.tol}, "bit_identical_to_solver": same,
          **rows})
    require(all(same.values()), f"serving 1M answers differ {same}")
    answers = [rows[k] for k in ("cold", "warm", "second_tenant",
                                 "restored", "dense_cold", "dense_warm")]
    require(all(a["meets_sla"] and a["fetches"] <= 2 + a["compiled"]
                for a in answers), f"serving 1M answers {answers}")
    require(all(a["meets_sla"] for a in rows["batch"]["answers"]),
            "serving 1M batch above tol")
    require(rows["warm"]["warm"] and rows["warm"]["iterations"]
            < rows["cold"]["iterations"], f"serving 1M warm {rows['warm']}")


def wide_problem(torch, dev, n: int):
    """A squared problem with ``n`` features a node on a 40-node SBM (24
    samples a node, every other node labeled): the CPU tests'
    ``_wide_problem`` on the card."""
    from repro_torch.api import Problem
    from repro_torch.core.graph import sbm_graph
    from repro_torch.core.losses import NodeData

    g, assign = sbm_graph(np.random.default_rng(17), (20, 20), 0.3, 0.05,
                          device=dev)
    rng = np.random.default_rng(18)
    levels = rng.standard_normal((2, n))
    x = rng.standard_normal((40, 24, n)).astype(np.float32)
    y = (np.einsum("vmn,vn->vm", x, levels[assign % 2])
         + 0.05 * rng.standard_normal((40, 24))).astype(np.float32)
    data = NodeData(torch.from_numpy(x), torch.from_numpy(y),
                    torch.ones((40, 24)),
                    torch.from_numpy((np.arange(40) % 2 == 0).astype(
                        np.float32))).to(dev)
    return Problem.create(g, data, 1e-2, device=dev)


def phase_wide_features(torch, dev) -> None:
    """Squared problems with n = 17 and 33 features (past the fused
    kernel's widest register tile): ``Solver(backend="pallas")`` takes
    the fused route on the card (the wide variant: fused launches under
    the ``"/wide"`` key, no ``tv_prox``), in float32 within 1e-4 of the
    dense backend and in bfloat16 within the reference's bf16 gates
    (final objective 0.15 relative, ``w`` 0.5 of its scale); and a tol
    solve at n = 33 whose fused block is captured under the tol engine's
    IF node, under ``set_sync_debug_mode("error")``, stopping where the
    plain loop stops."""
    from repro_torch.api import Solver, SolverConfig, backends

    t0 = time.perf_counter()
    rows = []
    for n in (17, 33):
        problem = wide_problem(torch, dev, n)
        cfg = SolverConfig(backend="pallas", num_iters=200, rho=1.9,
                           metric_every=50)
        want = Solver(cfg.replace(backend="dense")).run(problem)
        for dt in ("float32", "bfloat16"):
            reset_launches()
            got = Solver(cfg.replace(dtype=dt)).run(problem)
            torch.cuda.synchronize()
            launches = read_launches()
            dw = max_diff(got.w, want.w)
            obj_rel = float((got.objective[-1] - want.objective[-1]).abs()
                            / want.objective[-1].abs())
            w_rel = dw / float(want.w.abs().max())
            key = f"squared/{dt}/wide"
            row = {"num_features": n, "dtype": dt, "launches": launches,
                   "fused": backends._should_fuse(problem, cfg),
                   "max_abs_dw_vs_dense": dw,
                   "objective_rel_vs_dense": obj_rel}
            rows.append(row)
            require(launches["fused_pd_step_variants"].get(key, 0) > 0
                    and launches["tv_prox"] == 0,
                    f"n = {n} {dt}: not the fused wide variant {launches}")
            if dt == "float32":
                require(dw <= SOLVE_TOL, f"n = {n} fused vs dense |dw| {dw}")
            else:
                require(abs(obj_rel) <= 0.15 and w_rel <= 0.5,
                        f"n = {n} bf16 vs dense gates {row}")
    tol_cfg = SolverConfig(backend="pallas", num_iters=2000, rho=1.9,
                           metric_every=10, tol=1e-3)
    tol_row, _ = tol_solve(torch, wide_problem(torch, dev, 33), tol_cfg)
    emit({"phase": "wide_features", "seconds": time.perf_counter() - t0,
          "runs": rows, "tol": {"num_features": 33, "tol": 1e-3,
                                **tol_row}})
    executed = tol_row["device_executions"]["fused_pd_step"]
    require(tol_row["fetches"] == 1
            and executed >= tol_row["iterations"] // 10 > 1,
            f"n = 33 tol: the captured wide block did not run {tol_row}")


LANE_WINDOW_SAMPLES = 14523     # F1: fits the kernel's plan as one lane only
F2_LANES = 4097                 # F2: one lane past a launch's MAX_LANES
PHASES = ("alg1_gather_duals", "alg1_primal_prox", "alg1_edge_diff",
          "alg1_dual_prox", "alg1_km_relaxation")
FED_TOL = 1e-6                  # federated sync vs dense: w, objective rel


def phase_lane_faults(torch, dev) -> None:
    """Two lambda paths that once raised on the card (ROADMAP §3, F1 and
    F2 under "Fixed").  F1: a logistic problem whose nodes (14,523
    samples at n = 2) fit the kernel's staging plan as one lane but not
    as six; ``solve_path`` over six lambdas runs the fused lanes with the
    parameters streamed, each lane within SOLVE_TOL of a one-lane
    (staged) fused solve from the path's warm start (the streamed variant
    sums a labeled node's samples over a block, in another order) and of
    the dense path; on one step's inputs the six-lane streamed launch
    gives the bits of six one-lane streamed launches.  F2: the
    §5 instance over 4097 lambdas through the fused lanes: each step
    launches a group of MAX_LANES lanes and a group of one, and the
    first and last lanes equal one-lane fused solves from the same warm
    start bit for bit."""
    from repro_torch.api import Problem, SolverConfig, backends, solve_path
    from repro_torch.core.graph import sbm_graph
    from repro_torch.data.synthetic import (make_classification_data,
                                            make_sbm_regression)
    from repro_torch.engine import default_warm_lam
    from repro_torch.kernels import ops, pd_step

    t0 = time.perf_counter()
    rng = np.random.default_rng(LANE_WINDOW_SAMPLES)
    g, assign = sbm_graph(rng, (20, 20), 0.3, 0.05, device=dev)
    ds = make_classification_data(
        rng, g, np.where(assign[:, None] % 2 == 0, [2.0, 2.0], [-2.0, 2.0]),
        samples_per_node=LANE_WINDOW_SAMPLES, num_labeled=20)
    problem = Problem.create(g, ds.data, 1e-2, loss="logistic", device=dev)
    fits = {lanes: pd_step.plan_variant(2, 2, LANE_WINDOW_SAMPLES, lanes)
            for lanes in (1, 6)}
    require(fits == {1: "staged", 6: "streamed"}, f"F1 plan window {fits}")
    cfg = SolverConfig(backend="pallas", rho=1.9, warm_iters=30,
                       final_iters=30, metric_every=10)
    reset_launches()
    got = solve_path(problem, PATH_LAMS, cfg)
    torch.cuda.synchronize()
    f1_launches = read_launches()
    want = solve_path(problem, PATH_LAMS, cfg.replace(backend="dense"))
    f1_dw = max_diff(got.w, want.w)
    f1_warm = backends.solve_pallas(problem.with_lam(default_warm_lam(
        float(np.max(PATH_LAMS)))), cfg.replace(num_iters=cfg.warm_iters,
                                                compute_diagnostics=False))
    f1_one_lane_dw = {}
    for k in (0, len(PATH_LAMS) - 1):
        lam = float(PATH_LAMS[k])
        u0 = problem.regularizer.project_dual(f1_warm.u, problem.graph, lam)
        one = backends._solve_fused(problem.with_lam(lam), cfg.replace(
            num_iters=cfg.final_iters, compute_diagnostics=False),
            w0=f1_warm.w, u0=u0)
        f1_one_lane_dw[k] = max_diff(one.w, got.w[k])
    require(f1_launches["lanes"]["fused_pd_step"].get(
                "logistic/float32/streamed", 0) > 0
            and not f1_launches["lanes"]["tv_prox"],
            f"F1 path did not run the streamed fused lanes: {f1_launches}")
    require(all(d <= SOLVE_TOL for d in f1_one_lane_dw.values()),
            f"F1 lanes vs one-lane fused solves |dw| {f1_one_lane_dw}")
    require(f1_dw <= SOLVE_TOL, f"F1 path vs dense path |dw| = {f1_dw}")
    # one step's inputs: the six-lane launch (streamed by the plan) and
    # six one-lane launches with the streamed variant forced
    args, kw = problem_args(torch, problem, backends._graph_layout(g),
                            torch.float32, dev)
    largs = lane_args(torch, args, len(PATH_LAMS))
    reset_launches()
    lane_out = ops.pd_step(*largs, **kw)
    step_launches = read_launches()
    ones = [forced_streamed(pd_step.fused_pd_step, one_lane(largs, k), kw)
            for k in range(len(PATH_LAMS))]
    torch.cuda.synchronize()
    f1_step_identical = all(torch.equal(lane_out[i][k], one[i])
                            for k, one in enumerate(ones) for i in (0, 1))
    require(step_launches["lanes"]["fused_pd_step"].get(
                "logistic/float32/streamed", 0) == 1 and f1_step_identical,
            f"F1 step: six streamed lanes vs six one-lane streamed "
            f"launches: bit-identical {f1_step_identical}, launches "
            f"{step_launches}")
    del args, largs, lane_out, ones

    s5 = make_sbm_regression(seed=0)
    p5 = Problem.create(s5.graph, s5.data, 1e-3)
    lams = np.geomspace(1e-1, 1e-3, F2_LANES).astype(np.float32)
    cfg = SolverConfig(backend="pallas", fused=True, rho=1.9,
                       warm_iters=100, final_iters=100, metric_every=100,
                       compute_diagnostics=False)
    reset_launches()
    t1 = time.perf_counter()
    res = solve_path(p5, lams, cfg)
    torch.cuda.synchronize()
    f2_s = time.perf_counter() - t1
    f2_launches = read_launches()
    warm = backends.solve_pallas(p5.with_lam(default_warm_lam(
        float(np.max(lams)))), cfg.replace(num_iters=cfg.warm_iters))
    final_cfg = cfg.replace(num_iters=cfg.final_iters)
    identical = {}
    for k in (0, F2_LANES - 1):
        u0 = p5.regularizer.project_dual(warm.u, p5.graph, float(lams[k]))
        one = backends._solve_fused(p5.with_lam(float(lams[k])), final_cfg,
                                    w0=warm.w, u0=u0)
        identical[k] = bool(torch.equal(one.w, res.w[k])
                            and torch.equal(one.objective, res.objective[k]))
    emit({"phase": "lane_faults", "seconds": time.perf_counter() - t0,
          "f1": {"loss": "logistic", "samples_per_node": LANE_WINDOW_SAMPLES,
                 "variant": {str(k): v for k, v in fits.items()},
                 "lams": [float(x) for x in PATH_LAMS],
                 "launches": f1_launches, "max_abs_dw_vs_dense_path": f1_dw,
                 "max_abs_dw_vs_one_lane_solves": {
                     str(k): v for k, v in f1_one_lane_dw.items()},
                 "step_lanes_bit_identical_to_one_lane_streamed_launches":
                     f1_step_identical},
          "f2": {"lanes": F2_LANES, "max_lanes": pd_step.MAX_LANES,
                 "solve_path_seconds": f2_s, "launches": f2_launches,
                 "bit_identical_to_one_lane_solves": {
                     str(k): v for k, v in identical.items()}}})
    lane_launches = f2_launches["lanes"]["fused_pd_step"].get(
        "squared/float32", 0)
    require(res.w.shape[0] == F2_LANES
            and bool(torch.isfinite(res.w).all()), "F2 path result")
    require(lane_launches == 1 and f2_launches["fused_pd_step"] == 3,
            f"F2: not one 4096-lane and one one-lane launch after the warm "
            f"solve's: {f2_launches}")
    require(all(identical.values()), f"F2 lanes vs one-lane {identical}")


def range_device_ms(path: str, last: dict) -> dict:
    """Device time of the kernels launched inside the last ``last[name]``
    ranges of each name in a Chrome trace (``obs.profile.trace``; the
    last ones, since the tracer may drop the events of its first
    moments): each CPU range's kernel launches (the runtime calls inside
    its span) matched to their kernels by correlation id.  Returns
    {name: (ms, kernels)}, and under "all" every kernel launched from
    the first range counted on."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernel_us = {e["args"]["correlation"]: e["dur"] for e in events
                 if e.get("cat") == "kernel"
                 and "correlation" in e.get("args", {})}
    launches = sorted((e["ts"], kernel_us[e["args"]["correlation"]])
                      for e in events
                      if e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and e.get("args", {}).get("correlation") in kernel_us)
    launch_ts = [t for t, _ in launches]
    out, start = {}, float("inf")
    for name, count in last.items():
        ranges = sorted((e for e in events
                         if e.get("cat") == "user_annotation"
                         and e.get("name") == name),
                        key=lambda e: e["ts"])[-count:]
        ms, n = 0.0, 0
        for r in ranges:
            lo = bisect.bisect_left(launch_ts, r["ts"])
            hi = bisect.bisect_right(launch_ts, r["ts"] + r["dur"])
            ms += sum(us for _, us in launches[lo:hi]) / 1e3
            n += hi - lo
            start = min(start, r["ts"])
        out[name] = (ms, n)
    rest = launches[bisect.bisect_left(launch_ts, start):]
    out["all"] = (sum(us for _, us in rest) / 1e3, len(rest))
    return out


def phase_obs_full_size(torch, cfg, big, w_true, full_size_rate) -> None:
    """Telemetry at full size: the fused squared float32 solve of
    ``full_size`` with telemetry off and on (median of 3 each, after a
    warm-up; iterations/s both ways, the same bits both ways), one
    ``obs.profile.trace`` of a 100-iteration dense block (each
    Algorithm 1 phase's device ms, from the kernels launched inside its
    range), and the counter snapshot after a §5 tol solve with telemetry
    on (one transfer)."""
    import shutil

    from repro_torch import obs
    from repro_torch.api import Problem, Solver, SolverConfig
    from repro_torch.data.synthetic import make_sbm_regression

    t0 = time.perf_counter()
    obs.disable()
    obs.reset()
    iterations = cfg.warm_iters + cfg.final_iters
    Solver(cfg).run(big, w_true=w_true)
    rates, results = {}, {}
    for mode in ("off", "on", "off", "on", "off", "on"):
        (obs.enable if mode == "on" else obs.disable)()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        results[mode] = Solver(cfg).run(big, w_true=w_true)
        torch.cuda.synchronize()
        rates.setdefault(mode, []).append(
            iterations / (time.perf_counter() - t1))
    obs.disable()
    same = torch.equal(results["off"].w, results["on"].w)
    med = {k: float(np.median(v)) for k, v in rates.items()}

    logdir = ROOT / "build" / "obs_trace"
    block = SolverConfig(backend="dense", num_iters=100, rho=1.9,
                         metric_every=100, compute_diagnostics=False)
    Solver(block).run(big)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with obs.profile.trace(str(logdir)):
        for _ in range(2):             # the second block is read
            Solver(block).run(big)
        torch.cuda.synchronize()
    trace_s = time.perf_counter() - t1
    phases = range_device_ms(str(logdir / "trace.json"), {
        **{p: block.num_iters for p in PHASES}, "solve_metrics": 1})
    shutil.rmtree(logdir, ignore_errors=True)

    s5 = make_sbm_regression(seed=0)
    obs.reset()
    obs.enable()
    Solver(SolverConfig(num_iters=4000, rho=1.9, metric_every=10, tol=5e-3,
                        compute_diagnostics=False)).run(
        Problem.create(s5.graph, s5.data, 1e-2))
    snap = obs.export.snapshot()
    obs.disable()
    counters = {m["name"] + json.dumps(m["labels"], sort_keys=True):
                m["value"] for m in snap["metrics"]
                if m["kind"] == "counter"}
    emit({"phase": "obs_full_size", "seconds": time.perf_counter() - t0,
          "solve": "fused squared f32, continuation", "iterations": iterations,
          "iterations_per_s": rates, "median_iterations_per_s": med,
          "full_size_iterations_per_s": full_size_rate,
          "on_over_off": med["on"] / med["off"],
          "off_over_full_size": med["off"] / full_size_rate,
          "same_w_on_and_off": same,
          "dense_block": {"iterations": 100, "traced_seconds": trace_s,
                          "device_ms_per_iteration": {
                              k: v[0] / 100 for k, v in phases.items()},
                          "kernels_per_iteration": {
                              k: v[1] / 100 for k, v in phases.items()}},
          "counters": counters})
    require(same, "telemetry on changed the fused solve's result")
    require(all(f"{p}" in phases and phases[p][1] > 0 for p in PHASES),
            f"the dense trace lacks device time for a phase: {phases}")
    require(counters.get('repro_transfers_device_to_host_total{}') == 1.0,
            f"§5 tol solve with telemetry on: {counters}")


def phase_federated_s5(torch, dev) -> None:
    """The federated runtime in synchronous mode (``backend="federated"``:
    full participation, one local prox step, no compression) against the
    dense backend on the card: the §5 instance (continuation, 3000 + 1000
    rounds) and the 8 zoo scenarios (seed 0, smoke size, 200 rounds,
    rho 1.9): ``w`` within 1e-6, objective trace within rtol 1e-6."""
    from repro_torch.api import Problem, Solver, SolverConfig
    from repro_torch.data.synthetic import make_sbm_regression
    from repro_torch.scenarios import SCENARIOS, get_scenario

    t0 = time.perf_counter()
    s5 = make_sbm_regression(seed=0)
    runs = [("paper_s5", Problem.create(s5.graph, s5.data, 1e-3), s5.w_true,
             SolverConfig(continuation=True, rho=1.9, metric_every=100))]
    for name in sorted(SCENARIOS):
        inst = get_scenario(name).build(seed=0, smoke=True, device=dev)
        runs.append((name, inst.problem, inst.w_true,
                     SolverConfig(num_iters=200, rho=1.9)))
    rows = {}
    reset_launches()
    for name, problem, truth, cfg in runs:
        t1 = time.perf_counter()
        fed = Solver(cfg.replace(backend="federated")).run(problem,
                                                           w_true=truth)
        torch.cuda.synchronize()
        fed_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        dense = Solver(cfg).run(problem, w_true=truth)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t1
        dw, obj_rel = compare(fed, dense)
        rows[name] = {"max_abs_dw_vs_dense": dw,
                      "objective_max_rel_vs_dense": obj_rel,
                      "bit_identical": bool(torch.equal(fed.w, dense.w)),
                      "federated_seconds": fed_s, "dense_seconds": dense_s,
                      "comm": fed.diagnostics["comm"]}
        require(dw <= FED_TOL and obj_rel <= FED_TOL,
                f"federated sync vs dense on {name}: |dw| {dw}, obj {obj_rel}")
    launches = read_launches()
    emit({"phase": "federated_s5", "seconds": time.perf_counter() - t0,
          "tol": FED_TOL, "launches": launches, "runs": rows})


def phase_federated_full_size(torch, big, w_true) -> None:
    """The federated runtime at full size (the 1M clustered graph,
    squared loss, n = 2, lambda 1e-3), 200 rounds, metric_every 20:
    synchronous mode against 200 dense iterations (1e-6 bounds; rounds/s
    against iterations/s); ``bernoulli`` (0.5) + ``int8`` + ``prox`` (2
    steps), its ledger against a numpy recount from its schedule, bit for
    bit; the same run checkpointed every 100 rounds (checkpoint seconds
    and bytes), then interrupted at round 100 and resumed, bit-identical
    to the straight run; peak device memory."""
    import shutil

    from repro_torch import obs
    from repro_torch.api import Solver, SolverConfig
    from repro_torch.federated import (FederatedConfig, engine,
                                       get_local_update, get_participation,
                                       run_federated)

    t0 = time.perf_counter()
    rounds, me = 200, 20
    torch.cuda.reset_peak_memory_stats()

    def timed(fn):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t1

    reset_launches()
    sync, sync_s = timed(lambda: run_federated(big, FederatedConfig(
        num_rounds=rounds, rho=1.9, metric_every=me), w_true=w_true))
    launches = read_launches()
    dense, dense_s = timed(lambda: Solver(SolverConfig(
        num_iters=rounds, rho=1.9, metric_every=me)).run(big, w_true=w_true))
    dw, obj_rel = compare(sync, dense)
    require(dw <= FED_TOL and obj_rel <= FED_TOL,
            f"1M federated sync vs dense: |dw| {dw}, obj {obj_rel}")
    # a traced synchronous block: each phase's device ms a round (the
    # selects of the round protocol lie outside every phase; "all" is
    # every kernel of the block's rounds and its one metric evaluation)
    logdir = ROOT / "build" / "federated_trace"
    block = FederatedConfig(num_rounds=me, rho=1.9, metric_every=me,
                            compute_diagnostics=False)
    with obs.profile.trace(str(logdir)):
        for _ in range(2):             # the second block is read
            run_federated(big, block)
        torch.cuda.synchronize()
    phases = range_device_ms(str(logdir / "trace.json"), {
        **{p: me for p in PHASES + ("mailbox_exchange_diff",)},
        "solve_metrics": 1})
    shutil.rmtree(logdir, ignore_errors=True)

    partial = FederatedConfig(
        num_rounds=rounds, rho=1.9, metric_every=me, seed=16,
        participation=get_participation("bernoulli", p=0.5),
        local_update=get_local_update("prox", num_steps=2),
        compression="int8")
    t1 = time.perf_counter()
    engine.participation_schedule(partial, rounds, big.num_nodes)
    schedule_s = time.perf_counter() - t1
    part, part_s = timed(lambda: run_federated(big, partial))
    g = big.graph
    deg = {k: np.bincount(getattr(g, k).cpu().numpy(),
                          minlength=big.num_nodes).astype(np.float64)
           for k in ("src", "dst")}
    up = (part.schedule.astype(np.float64) @ deg["dst"]).astype(np.float32)
    down = (part.schedule.astype(np.float64) @ deg["src"]).astype(np.float32)
    n = big.num_features
    want = {"up_msgs": up, "up_bytes": up * np.float32(n + 4.0),
            "down_msgs": down, "down_bytes": down * np.float32(4.0 * n)}
    ledger_equal = {k: bool(np.array_equal(
        getattr(part.ledger, k).cpu().numpy(), v)) for k, v in want.items()}
    require(all(ledger_equal.values()),
            f"1M ledger vs the schedule's recount: {ledger_equal}")

    ckdir = ROOT / "build" / "federated_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    saves = []
    real_save = engine._save_checkpoint

    def save(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        real_save(*a, **kw)
        saves.append(time.perf_counter() - t1)

    engine._save_checkpoint = save
    try:
        ck = partial.replace(checkpoint_dir=str(ckdir), checkpoint_every=100)
        straight, straight_s = timed(lambda: run_federated(big, ck))
        ck_bytes = sum(f.stat().st_size for f in ckdir.rglob("*")
                       if f.is_file())
        shutil.rmtree(ckdir)
        run_federated(big, ck.replace(num_rounds=100))
        resumed, resumed_s = timed(lambda: run_federated(
            big, ck.replace(resume=True)))
    finally:
        engine._save_checkpoint = real_save
        shutil.rmtree(ckdir, ignore_errors=True)
    fields = ("up_msgs", "up_bytes", "down_msgs", "down_bytes")
    bitwise = {
        "resumed_vs_straight": all(
            torch.equal(getattr(straight, k), getattr(resumed, k))
            for k in ("w", "u", "objective"))
        and all(torch.equal(getattr(straight.ledger, f),
                            getattr(resumed.ledger, f)) for f in fields),
        "checkpointed_vs_unchunked": bool(torch.equal(straight.w, part.w))}
    emit({"phase": "federated_full_size",
          "seconds": time.perf_counter() - t0, "nodes": big.num_nodes,
          "edges": g.num_edges, "rounds": rounds, "metric_every": me,
          "sync": {"seconds": sync_s, "rounds_per_s": rounds / sync_s,
                   "dense_seconds": dense_s,
                   "dense_iterations_per_s": rounds / dense_s,
                   "max_abs_dw_vs_dense": dw,
                   "objective_max_rel_vs_dense": obj_rel,
                   "bit_identical": bool(torch.equal(sync.w, dense.w)),
                   "launches": launches,
                   "device_ms_per_round": {
                       k: v[0] / me for k, v in phases.items()},
                   "kernels_per_round": {
                       k: v[1] / me for k, v in phases.items()}},
          "partial": {"participation": "bernoulli 0.5", "compression": "int8",
                      "local_update": "prox 2", "seconds": part_s,
                      "rounds_per_s": rounds / part_s,
                      "schedule_seconds": schedule_s,
                      "ledger_equal_to_recount": ledger_equal,
                      "comm": part.ledger.summary(),
                      "objective_first_last": [
                          float(part.objective[0]),
                          float(part.objective[-1])]},
          "checkpoint": {"every": 100, "straight_seconds": straight_s,
                         "resumed_seconds": resumed_s,
                         "save_seconds": saves, "bytes": ck_bytes,
                         "bitwise": bitwise},
          "max_memory_allocated": torch.cuda.max_memory_allocated()})
    require(all(bitwise.values()), f"1M checkpoint resume: {bitwise}")
    require(bool(torch.isfinite(part.w).all())
            and float(part.objective[-1]) < float(part.objective[0]),
            "1M partial run did not move the objective down")


# ---------------------------------------------------------------------------
# The sharded backends: halo exchange over a mesh of ranks, and the fused
# kernel inside each shard (core/distributed.py, core/mesh.py)
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def timed_run(torch):
    """Time the sharded ``Solver.run`` inside the block, telemetry on:
    yields a dict that holds, after the block, ``seconds`` (the block,
    to the card's finish), ``plan_seconds`` (the run's ``sharded_plan``
    span: its ``shard_problem*`` call) and ``solve_seconds`` (the rest:
    the loop, the final gathers and the final metrics).  Telemetry adds
    the engine's ``record_function`` ranges to the loop."""
    from repro_torch import obs

    obs.reset()
    obs.enable()
    rec = {}
    t0 = time.perf_counter()
    try:
        yield rec
        torch.cuda.synchronize()
        rec["seconds"] = time.perf_counter() - t0
        (plan,) = [h for h in obs.REGISTRY.find("repro_span_seconds")
                   if dict(h.labels)["span"] == "sharded_plan"]
        rec["plan_seconds"] = plan.sum
        rec["solve_seconds"] = rec["seconds"] - plan.sum
    finally:
        obs.disable()
        obs.reset()


def shard_step_args(torch, hp, reg, lam: float, rho: float, seed: int):
    """One fused step's ``kernels.ops.pd_step`` arguments on the layout of
    the sharded problem ``hp`` (a ``HierarchicalProblem``), as
    ``solve_nlasso_hier`` launches it, from a state that moves: w at the
    solve's scale on the layout rows (zero past them), each owned dual
    drawn uniformly from its box.  Returns (args, kw)."""
    h = hp.hier
    dev = hp.tau.device
    n = hp.num_features
    nv, ne, lo = h.nodes_pad, h.edges_pad, h.klo * h.block_edges
    gen = torch.Generator(device=dev).manual_seed(seed)
    la = lam * hp.bound_unit
    w_store = torch.zeros((h.w_store_rows, n), device=dev)
    w_store[:nv] = 2.0 * torch.randn((nv, n), generator=gen, device=dev)
    u_store = torch.zeros((h.u_store_rows, n), device=dev)
    u_store[lo:lo + ne] = la * (2.0 * torch.rand(
        (ne, n), generator=gen, device=dev) - 1.0)
    pkeys = tuple(sorted(hp.prox_params))
    args = (w_store, u_store, hp.inc_edges, hp.inc_signs,
            tuple(hp.prox_params[k].contiguous() for k in pkeys), hp.tau,
            hp.src, hp.dst, torch.full((ne, 1), 0.5, device=dev), la)
    kw = dict(loss=hp.loss, reg=reg, pkeys=pkeys,
              block_nodes=h.block_nodes, block_edges=h.block_edges,
              kn=h.kn, klo=h.klo, khi=h.khi, rho=rho,
              incidence=hp.incidence)
    return args, kw


def shard_kernel_check(torch, hp, lam: float, rho: float, seed: int
                       ) -> dict:
    """``fused_pd_step`` against its plain version on one shard's layout,
    one step from a moving state; the layout's extents beside."""
    from repro_torch.api.regularizers import TotalVariation
    from repro_torch.kernels import ops

    args, kw = shard_step_args(torch, hp, TotalVariation(), lam, rho, seed)
    k_out = ops.pd_step(*args, **kw)
    p_out = plain_step(*args, **kw)
    h = hp.hier
    nv = h.nodes_pad
    return {"shard": hp.shard, "max_abs_err": max(
                max_diff(k_out[0], p_out[0]), max_diff(k_out[1], p_out[1])),
            "layout_nodes": int((h.node_map[hp.shard * nv:
                                            (hp.shard + 1) * nv] >= 0).sum()),
            "owned_nodes": int(hp.node_owned.sum()),
            "num_blocks": h.num_blocks, "block_nodes": h.block_nodes,
            "block_edges": h.block_edges, "kn": h.kn, "klo": h.klo,
            "khi": h.khi, "replicated_slots": int(hp.recv_slots.numel())}


SHARDED_COLUMNS = (("sharded_dense", dict(backend="sharded", comm="dense")),
                   ("sharded_boundary", dict(backend="sharded",
                                             comm="boundary")),
                   ("sharded_fused", dict(backend="sharded_fused")))


def phase_sharded_s5(torch, dev) -> float:
    """The sharded backends on a one-rank mesh on the card: the §5
    instance (lambda 1e-3) and the eight scenarios at smoke size, 200
    iterations at rho 1.9, through ``sharded`` (dense and boundary
    exchange) and ``sharded_fused``, each against the dense backend on the
    card (``w`` within SOLVE_TOL, final objective within rtol SOLVE_TOL);
    ``sharded_fused`` must run ``fused_pd_step`` once an iteration on the
    card, counted by the kernel, ``sharded`` never (it runs no kernel of
    its own).  Then, on the §5 graph cut into 4 shards, the kernel
    against its plain version on each shard's layout (padding rows, the
    across-shard extents), whose largest error it returns."""
    from repro_torch.api import Problem, Solver, SolverConfig
    from repro_torch.core.distributed import shard_problem_fused
    from repro_torch.core.mesh import make_host_mesh
    from repro_torch.data.synthetic import make_sbm_regression
    from repro_torch.scenarios import SCENARIOS, get_scenario

    t0 = time.perf_counter()
    mesh = make_host_mesh(1, 1, device=dev)
    base = SolverConfig(num_iters=200, rho=1.9)
    s5 = make_sbm_regression(seed=0, device=dev)
    runs = [("paper_s5", Problem.create(s5.graph, s5.data, 1e-3,
                                        device=dev))]
    runs += [(name, get_scenario(name).build(seed=0, smoke=True,
                                             device=dev).problem)
             for name in sorted(SCENARIOS)]
    rows = {}
    for name, problem in runs:
        dense = Solver(base).run(problem)
        row = {}
        for column, kw in SHARDED_COLUMNS:
            counts = {}
            t1 = time.perf_counter()
            with device_executions(torch, counts):
                res = Solver(base.replace(mesh=mesh, **kw)).run(problem)
            dw = max_diff(res.w, dense.w)
            obj_rel = float((res.objective[-1] - dense.objective[-1]).abs()
                            / dense.objective[-1].abs())
            row[column] = {"seconds": time.perf_counter() - t1,
                           "max_abs_dw_vs_dense": dw,
                           "objective_rel_vs_dense": obj_rel,
                           "fused_pd_step_runs": counts["fused_pd_step"],
                           "halo_bytes_per_iter": res.diagnostics[
                               "halo_exchange_bytes_per_iter"]}
            want_runs = base.num_iters if kw["backend"] == "sharded_fused" \
                else 0
            require(dw <= SOLVE_TOL and obj_rel <= SOLVE_TOL
                    and counts["fused_pd_step"] == want_runs
                    and bool(torch.isfinite(res.w).all()),
                    f"sharded_s5 {name} {column}: {row[column]}")
        rows[name] = row
    shards = [shard_kernel_check(torch, shard_problem_fused(
        s5.graph, s5.data, 4, shard=s), 1e-3, 1.9, seed=s)
        for s in range(4)]
    for r in shards:
        require(r["max_abs_err"] <= STEP_TOL,
                f"sharded_s5: the kernel on shard {r['shard']}'s layout: {r}")
    emit({"phase": "sharded_s5", "seconds": time.perf_counter() - t0,
          "num_iters": base.num_iters, "rho": base.rho, "tol": SOLVE_TOL,
          "runs": rows, "shard_layouts_4": shards})
    return max(r["max_abs_err"] for r in shards)


def free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_sharded_full_size(torch, dev) -> dict:
    """The SHARDED_NODES clustered graph (``make_clustered``: squared
    loss, n = 2, lambda 1e-3; the 1M graph's hierarchical plan takes
    55-65 s, which the script's time limit cannot hold beside the other
    phases) through ``sharded_fused`` and ``sharded`` (dense exchange)
    in an NCCL world of one rank, SHARDED_ITERS iterations each at rho
    1.9, each against the dense backend's solve of that budget (``w``
    within SOLVE_TOL, final objective within rtol SOLVE_TOL).  One shard
    holds the whole graph, so the partitioner is "block" (the greedy
    "cluster" one would assign the same nodes after a Python heap walk
    over all of them).  ``sharded_fused`` runs the backend's two layers,
    as the reference's ``benchmarks/scaling.py`` does:
    ``shard_problem_fused`` with the backend's window hint, then
    ``solve_nlasso_hier``, so that the one plan also serves the kernel's
    check on its layout; ``sharded`` runs ``Solver.run``.  Per run:
    planning seconds, the solve's seconds and iterations/s (the final
    gathers included), halo bytes per iteration; for ``sharded_fused``
    the kernel's launches and device runs, and the kernel alone on the
    shard layout (ms a call, its plain version's, the bound).  Returns
    the kernels' line entry."""
    import torch.distributed as dist

    from repro_torch.api import Problem, Solver, SolverConfig
    from repro_torch.api.backends import _fused_window_cap
    from repro_torch.core.distributed import (halo_exchange_bytes_per_iter,
                                              shard_problem_fused,
                                              solve_nlasso_hier)
    from repro_torch.core.mesh import make_host_mesh
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    graph, data, _, _ = make_clustered(SHARDED_NODES, seed=0, device=dev)
    prob = Problem.create(graph, data, 1e-3, device=dev)
    del graph, data
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device=dev, group=dist.group.WORLD)
        base = SolverConfig(num_iters=SHARDED_ITERS, rho=1.9,
                            metric_every=SHARDED_ITERS)
        t1 = time.perf_counter()
        dense = Solver(base).run(prob)
        torch.cuda.synchronize()
        dense_s = time.perf_counter() - t1
        n = prob.num_features
        hint = (n, prob.loss.prox_param_floats(prob.data.x.shape[-2], n),
                4, _fused_window_cap())

        def check(column, w, objective, record):
            dw = max_diff(w, dense.w)
            obj_rel = float((objective - dense.objective[-1]).abs()
                            / dense.objective[-1].abs())
            record.update(max_abs_dw_vs_dense=dw,
                          objective_rel_vs_dense=obj_rel,
                          iterations_per_s=SHARDED_ITERS
                          / record["solve_seconds"])
            want_runs = SHARDED_ITERS if column == "sharded_fused" else 0
            require(dw <= SOLVE_TOL and obj_rel <= SOLVE_TOL
                    and record["fused_pd_step_runs"] == want_runs
                    and bool(torch.isfinite(w).all()),
                    f"sharded_full_size {column}: {record}")
            return record

        runs, counts = {}, {}
        t1 = time.perf_counter()
        hp = shard_problem_fused(prob.graph, prob.data, 1, partitioner="block",
                                 loss=prob.loss, window_hint=hint)
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t1
        reset_launches()
        t1 = time.perf_counter()
        with device_executions(torch, counts):
            w, _, _, comm = solve_nlasso_hier(
                hp, mesh, float(prob.lam), SHARDED_ITERS, rho=1.9,
                reg=prob.regularizer)
            torch.cuda.synchronize()
        solve_s = time.perf_counter() - t1
        launches = read_launches()["fused_pd_step"]
        runs["sharded_fused"] = check("sharded_fused", w, prob.objective(w), {
            "seconds": plan_s + solve_s, "plan_seconds": plan_s,
            "solve_seconds": solve_s, "comm": comm,
            "halo_bytes_per_iter": halo_exchange_bytes_per_iter(hp, comm, n),
            "fused_pd_step_launches": launches,
            "fused_pd_step_runs": counts["fused_pd_step"]})
        del w
        reset_launches()
        with timed_run(torch) as rec, device_executions(torch, counts):
            res = Solver(base.replace(mesh=mesh, partitioner="block",
                                      backend="sharded", comm="dense")
                         ).run(prob)
        runs["sharded_dense"] = check("sharded_dense", res.w,
                                      res.objective[-1], dict(
            rec, halo_bytes_per_iter=res.diagnostics[
                "halo_exchange_bytes_per_iter"],
            fused_pd_step_launches=read_launches()["fused_pd_step"],
            fused_pd_step_runs=counts["fused_pd_step"],
            dual_infeasibility=float(
                res.diagnostics["dual_infeasibility"])))
        del res
        # the kernel alone on the shard's layout
        args, kw = shard_step_args(torch, hp, prob.regularizer, prob.lam, 1.9,
                                   seed=1)
        ms = cuda_ms(lambda _: ops.pd_step(*args, **kw), reps=20)
        plain_ms = cuda_ms(lambda _: plain_step(*args, **kw), reps=3)
        k_out = ops.pd_step(*args, **kw)
        p_out = plain_step(*args, **kw)
        err = max(max_diff(k_out[0], p_out[0]), max_diff(k_out[1], p_out[1]))
        cost = step_cost(args, kw, prob.loss)
        h = hp.hier
        kernel = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                  "layout": {"num_blocks": h.num_blocks,
                             "block_nodes": h.block_nodes,
                             "block_edges": h.block_edges, "kn": h.kn,
                             "klo": h.klo, "khi": h.khi},
                  **{k: cost[k] for k in ("bound_ms", "bound_by",
                                          "bytes_read", "bytes_written")}}
        require(err <= STEP_TOL, f"sharded_full_size kernel vs plain {err}")
        emit({"phase": "sharded_full_size",
              "seconds": time.perf_counter() - t0, "transport": "nccl",
              "ranks": 1, "via_host": mesh.via_host,
              "nodes": prob.num_nodes, "edges": prob.graph.num_edges,
              "iterations": SHARDED_ITERS, "dense_seconds": dense_s,
              "dense_iterations_per_s": SHARDED_ITERS / dense_s,
              "runs": runs, "kernel_on_shard_layout": kernel})
    finally:
        dist.destroy_process_group()
    return dict(KERNELS["fused_pd_step[sharded]"], launches=launches,
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=cost["bound_ms"], bound_by=cost["bound_by"],
                library_ms=None)


def sharded_rank(rank: int, world: int, out: str) -> None:
    """One rank of a ``sharded_ranks`` world (a spawned process on the
    one card): join the gloo world, solve the RANK_NODES graph through
    every sharded column (``sharded_fused`` twice), and write each
    ``w`` and a record of the run into ``out``."""
    import torch
    import torch.distributed as dist

    if str(ROOT / "src") not in sys.path:
        sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import Problem, Solver, SolverConfig
    from repro_torch.core.mesh import make_host_mesh

    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    try:
        mesh = make_host_mesh(world, 1, device=dev)
        graph, data, _, _ = make_clustered(RANK_NODES, seed=0, device=dev)
        problem = Problem.create(graph, data, 1e-3, device=dev)
        base = SolverConfig(num_iters=RANK_ITERS, rho=1.9, mesh=mesh)
        arrays, runs = {}, {}
        for column, kw in SHARDED_COLUMNS + (
                ("sharded_fused_rerun", dict(backend="sharded_fused")),):
            counts = {}
            with timed_run(torch) as rec, device_executions(torch, counts):
                res = Solver(base.replace(**kw)).run(problem)
            arrays[column] = res.w.cpu().numpy()
            runs[column] = dict(
                rec, iterations_per_s=RANK_ITERS / rec["solve_seconds"],
                halo_bytes_per_iter=res.diagnostics[
                    "halo_exchange_bytes_per_iter"],
                fused_pd_step_runs=counts["fused_pd_step"])
        np.savez(Path(out) / f"rank{rank}.npz", **arrays)
        (Path(out) / f"rank{rank}.json").write_text(json.dumps({
            "transport": mesh.transport, "via_host": mesh.via_host,
            "seconds": time.perf_counter() - t0, "runs": runs}))
    finally:
        dist.destroy_process_group()


def phase_sharded_ranks(torch, dev) -> None:
    """Worlds of RANK_WORLDS processes on the one card over gloo (NCCL
    refuses two ranks on one GPU), each rank loading the library
    ``phase_build`` built: the RANK_NODES clustered graph (squared,
    n = 2, lambda 1e-3), RANK_ITERS iterations at rho 1.9, through
    ``sharded`` (dense and boundary exchange) and ``sharded_fused``
    (``comm="auto"``, twice).  Every rank's ``w`` against the dense
    backend's on the card (``sharded`` within RANK_TOL, ``sharded_fused``
    within SOLVE_TOL and bit-identical between its two runs), the same on
    every rank; each rank's ``fused_pd_step`` runs counted by the kernel
    (one an iteration in ``sharded_fused``, none in ``sharded``).  Gloo
    takes host tensors: the exchange goes through the host."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.api import Problem, Solver, SolverConfig

    t0 = time.perf_counter()
    graph, data, _, _ = make_clustered(RANK_NODES, seed=0, device=dev)
    problem = Problem.create(graph, data, 1e-3, device=dev)
    want = Solver(SolverConfig(num_iters=RANK_ITERS, rho=1.9,
                               metric_every=RANK_ITERS)).run(problem).w
    want = want.cpu().numpy()
    del graph, data, problem
    worlds = {}
    bounds = {"sharded_dense": RANK_TOL, "sharded_boundary": RANK_TOL,
              "sharded_fused": SOLVE_TOL, "sharded_fused_rerun": SOLVE_TOL}
    for size in RANK_WORLDS:
        (ROOT / "build").mkdir(exist_ok=True)
        out = Path(tempfile.mkdtemp(prefix="ranks", dir=ROOT / "build"))
        try:
            t1 = time.perf_counter()
            mp.spawn(sharded_rank, args=(size, str(out)), nprocs=size,
                     join=True)
            spawn_s = time.perf_counter() - t1
            ranks = [(dict(np.load(out / f"rank{r}.npz")),
                      json.loads((out / f"rank{r}.json").read_text()))
                     for r in range(size)]
        finally:
            shutil.rmtree(out, ignore_errors=True)
        errs = {c: max(float(np.abs(a[c] - want).max()) for a, _ in ranks)
                for c in bounds}
        same = all(np.array_equal(a[c], ranks[0][0][c])
                   for a, _ in ranks for c in bounds)
        rerun = all(np.array_equal(a["sharded_fused"],
                                   a["sharded_fused_rerun"])
                    for a, _ in ranks)
        worlds[size] = {"seconds": spawn_s, "max_abs_dw_vs_dense": errs,
                        "same_w_on_every_rank": same,
                        "sharded_fused_rerun_bit_identical": rerun,
                        "ranks": [rec for _, rec in ranks]}
        require(all(errs[c] <= bounds[c] for c in bounds) and same and rerun,
                f"sharded_ranks world of {size}: {worlds[size]}")
        for r, (_, rec) in enumerate(ranks):
            runs = rec["runs"]
            require(rec["transport"] == "gloo" and rec["via_host"]
                    and all(runs[c]["fused_pd_step_runs"]
                            == (RANK_ITERS if c.startswith("sharded_fused")
                                else 0) for c in runs),
                    f"sharded_ranks world of {size}, rank {r}: {rec}")
    emit({"phase": "sharded_ranks", "seconds": time.perf_counter() - t0,
          "nodes": RANK_NODES, "iterations": RANK_ITERS,
          "transport": "gloo", "exchange_through_host": True,
          "tol": bounds, "worlds": worlds})


DATA_FIELDS = ("x", "y", "sample_mask", "labeled_mask")
# the A/B instance's problems: loss -> (lambda, loss options)
AB_PROBLEMS = {"squared": (1e-3, {}), "logistic": (1e-3, {}),
               "lasso": (1e-2, LASSO_KW)}


def compact_build_seconds(lt) -> float:
    """Host seconds to build the layout's compact incidence from its
    padded tables (``core/graph.py:compact_incidence``, which the planner
    runs once per layout)."""
    from repro_torch.core.graph import compact_incidence
    inc_e, inc_s = lt.inc_edges.cpu().numpy(), lt.inc_signs.cpu().numpy()
    t0 = time.perf_counter()
    compact_incidence(inc_e, inc_s)
    return time.perf_counter() - t0


def save_instance(path: Path, device="cuda") -> None:
    """Generate the full-size instance and save the graph, its clusters,
    the squared loss's data and the logistic and lasso data of
    ``loss_instances`` to ``path`` (.npz), so that every process of an
    A/B comparison solves the same instances (the wide ones are drawn
    from their seed on the card in each process: ``wide_instances``)."""
    graph, data, w_true, assign = make_clustered(FULL_NODES, seed=0,
                                                 device=device)
    others = loss_instances(graph, assign, seed=1)
    arrays = {f"g_{k}": getattr(graph, k).cpu().numpy()
              for k in ("src", "dst", "weights", "inc_edges", "inc_signs")}
    arrays.update({f"d_{k}": getattr(data, k).cpu().numpy()
                   for k in DATA_FIELDS})
    for loss, (prob, _) in others.items():
        arrays.update({f"{loss}_{k}": getattr(prob.data, k).cpu().numpy()
                       for k in DATA_FIELDS})
    np.savez(path, num_nodes=graph.num_nodes, w_true=w_true.cpu().numpy(),
             assign=np.asarray(assign), **arrays)


@contextlib.contextmanager
def one_phase(keep: str):
    """Launch ``fused_pd_step`` with only its node phase (``keep=
    "node"``) or only its edge phase (``"edge"``): the launch arguments
    get the other phase's extent set to 0, so that phase's loop runs no
    iteration.  For the phase split of a step; the grid is the same
    (the cooperative grid is capped by residency at this size)."""
    from repro_torch.kernels import _build
    real = _build.entry

    def entry(name, argtypes):
        fn = real(name, argtypes)
        if name != "fused_pd_step_launch":
            return fn

        def launch(args_ref, stream):
            args = args_ref._obj
            if keep == "node":
                args.num_edges = 0
            else:
                args.num_nodes = 0
            return fn(args_ref, stream)
        return launch

    _build.entry = entry
    try:
        yield
    finally:
        _build.entry = real


def problem_args(torch, problem, lt, store, device, compact=True):
    """One step's arguments of ``problem`` on layout ``lt`` for
    ``kernels.ops.pd_step`` in storage ``store`` (rho 1.9), from a state
    that moves (``moving_state``); ``compact``: pass the compact
    incidence the checkout's kernel reads.  Returns (args, kw)."""
    from repro_torch.api import backends

    (params_s, pkeys, _, tau_s, _, sig2, src2, dst2, la2, _) = \
        backends._fused_setup(problem.graph, problem.data, problem.lam,
                              None, loss=problem.loss,
                              reg=problem.regularizer, layout=lt,
                              dtype=store)
    w_store, u_store = moving_state(torch, lt, problem.num_features, la2,
                                    device, store)
    args = (w_store, u_store, lt.pad_node_store(lt.inc_edges),
            lt.pad_node_store(lt.inc_signs), params_s, tau_s, src2, dst2,
            sig2, la2)
    kw = dict(loss=problem.loss, reg=problem.regularizer, pkeys=pkeys,
              block_nodes=lt.block_nodes, block_edges=lt.block_edges,
              kn=lt.kn, klo=lt.klo, khi=lt.khi, rho=1.9)
    if compact:
        kw["incidence"] = lt.compact
    return args, kw


def time_variants(torch, problems: dict, lt, compact: bool,
                  device) -> dict:
    """Each ``fused_pd_step`` variant of ``problems`` ({loss: Problem})
    alone, in float32 and bfloat16 storage, from a state that moves: ms
    per ``iters=1`` step, and the step with only its node phase (D^T u
    gather, prox, z, KM) or only its edge phase (D z, resolvent, KM)
    launched.  ``compact``: the checkout's kernel reads the compact
    incidence."""
    from repro_torch.kernels import ops

    rows = {}
    for loss, dtype in VARIANTS:
        if loss not in problems:
            continue
        args, kw = problem_args(torch, problems[loss], lt,
                                getattr(torch, dtype), device, compact)

        def step(_):
            return ops.pd_step(*args, **kw)

        row = {"ms_per_step": cuda_ms(step, reps=20)}
        for phase in ("node", "edge"):
            with one_phase(phase):
                row[f"{phase}_phase_ms"] = cuda_ms(step, reps=20)
        rows[f"{loss}/{dtype}"] = row
        del args
        torch.cuda.empty_cache()
    return rows


def time_wide_variants(torch, graph, assign, lt, compact: bool,
                       device) -> dict:
    """``time_variants`` for the wide kernel: each loss of
    ``wide_instances`` at n = WIDE_N on the saved graph, drawn from its
    seed on the card (one loss at a time: the squared one's samples and
    P are ~8 GB), float32 and bfloat16."""
    rows = {}
    for loss in ("squared", "lasso", "logistic"):
        problem = wide_instances(graph, assign, seed=2,
                                 losses=(loss,))[loss][0]
        rows.update({f"{k}/wide": v for k, v in time_variants(
            torch, {loss: problem}, lt, compact, device).items()})
        del problem
        torch.cuda.empty_cache()
    return rows


def time_streamed_variants(torch, compact: bool, device) -> dict:
    """``time_variants`` for the register tile's streamed logistic
    variant, on the many-sample instance (``many_samples_instance``,
    drawn from its seed on the card), float32 and bfloat16; and one
    launch over six lanes (the step's state, lambda from 1x to 0.1x:
    ``lane_args``) in float32."""
    from repro_torch.api import SolverConfig, backends
    from repro_torch.kernels import ops

    problem, _ = many_samples_instance(torch, device)
    require(backends._should_fuse(problem, SolverConfig(backend="pallas")),
            "many-sample instance: no fusion")
    lt = backends._graph_layout(problem.graph)
    rows = {f"{k}/streamed": v for k, v in time_variants(
        torch, {"logistic": problem}, lt, compact, device).items()}
    args, kw = problem_args(torch, problem, lt, torch.float32, device,
                            compact)
    largs = lane_args(torch, args, len(PATH_LAMS))
    rows["logistic/float32/streamed/lanes"] = {
        "lanes": len(PATH_LAMS),
        "ms_per_launch": cuda_ms(lambda _: ops.pd_step(*largs, **kw),
                                 reps=10)}
    del problem, args, largs
    torch.cuda.empty_cache()
    return rows


def time_fused_solve(root: Path, path: Path, reps: int = 3,
                     device="cuda") -> dict:
    """In this process, with the ``repro_torch`` of checkout ``root``:
    the saved instance's layout planned by the fused gate (host seconds,
    after the kernel library is built: the set-up a solve pays), the
    fused squared float32 continuation solve (after one warm-up solve),
    and every ``fused_pd_step`` variant alone per step with its phase
    split (``time_variants``; the wide ones at n = WIDE_N:
    ``time_wide_variants``; the register tile's streamed logistic one on
    the many-sample instance: ``time_streamed_variants``).  Uses only
    what every slice of the port since the third has (the wide and
    streamed rows: since the eighth), and passes the compact incidence
    where the checkout's kernel reads it, so it times the parent
    checkout as well."""
    import inspect

    import torch
    sys.path.insert(0, str(root / "src"))
    from repro_torch import interop
    from repro_torch.api import Problem, Solver, SolverConfig, backends
    from repro_torch.kernels import _build, ops

    z = np.load(path)
    graph = interop.graph_from_arrays(
        **{k: z[f"g_{k}"] for k in ("src", "dst", "weights", "inc_edges",
                                    "inc_signs")},
        num_nodes=int(z["num_nodes"]), device=device)
    problems = {}
    for loss, (lam, opts) in AB_PROBLEMS.items():
        prefix = "d" if loss == "squared" else loss
        data = interop.node_data_from_arrays(
            *(z[f"{prefix}_{k}"] for k in DATA_FIELDS), device=device)
        problems[loss] = Problem.create(graph, data, lam, loss=loss,
                                        device=device, **opts)
    w_true = torch.from_numpy(z["w_true"]).to(device)
    cfg = SolverConfig(backend="pallas", fused=True, continuation=True,
                       rho=1.9, metric_every=100)
    _build.library()
    t0 = time.perf_counter()
    require(backends._should_fuse(problems["squared"], cfg),
            "A/B instance: no fusion")
    plan_s = time.perf_counter() - t0
    lt = backends._graph_layout(graph)
    compact = "incidence" in inspect.signature(ops.pd_step).parameters
    out = {"root": str(root), "compact_incidence": compact,
           "plan_seconds": plan_s}
    if compact:
        out["compact_incidence_build_seconds"] = compact_build_seconds(lt)
    Solver(cfg).run(problems["squared"], w_true=w_true)
    rates = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        Solver(cfg).run(problems["squared"], w_true=w_true)
        torch.cuda.synchronize()
        rates.append((cfg.warm_iters + cfg.final_iters)
                     / (time.perf_counter() - t0))
    out["kernels"] = time_variants(torch, problems, lt, compact, device)
    out["wide_kernels"] = time_wide_variants(torch, graph, z["assign"], lt,
                                             compact, device)
    out["streamed_kernels"] = time_streamed_variants(torch, compact, device)
    if compact:
        out["kernel_digests"] = kernel_digests(torch, device)
    return {**out, "iterations_per_s": rates}


def ab_main(argv: list) -> int:
    """``--ab PARENT``: with the parent checkout ``PARENT`` and this one,
    in turns (parent, change, change, parent), each in its own process
    on the saved full-size instances: the fused squared float32 solve,
    and every ``fused_pd_step`` variant's ms per step with its node and
    edge phases (``time_variants``; the wide variant at n = WIDE_N on
    the same graph, ``time_wide_variants``; the streamed logistic one on
    the many-sample instance in float32, bfloat16 and over six lanes,
    ``time_streamed_variants``), and the register-tile kernel's
    outputs on ``kernel_vs_plain``'s inputs, which must be the same bits
    in every process (``kernel_digests``).  ``--time-solve ROOT NPZ``:
    one such process."""
    import subprocess as sp

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if argv[0] == "--time-solve":
        emit(time_fused_solve(Path(argv[1]).resolve(), Path(argv[2])))
        return 0
    require(argv[0] == "--ab" and len(argv) == 2, f"arguments {argv}")
    parent = Path(argv[1]).resolve()
    sys.path.insert(0, str(ROOT / "src"))
    path = ROOT / "build" / "ab_instance.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    save_instance(path)
    emit({"phase": "ab_instance", "seconds": time.perf_counter() - t0})
    runs = []
    try:
        for root in (parent, ROOT, ROOT, parent):
            proc = sp.run([sys.executable, str(Path(__file__).resolve()),
                           "--time-solve", str(root), str(path)],
                          capture_output=True, text=True, timeout=1200,
                          check=False)
            require(proc.returncode == 0,
                    f"A/B run in {root} failed:\n{proc.stderr[-4000:]}")
            runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
            emit(runs[-1])
    finally:
        path.unlink(missing_ok=True)
    digests = [r.get("kernel_digests") for r in runs]
    same = all(d == digests[0] for d in digests) and digests[0] is not None
    print(card_line(), flush=True)
    emit({"phase": "ab", "parent": str(parent),
          "kind": torch.cuda.get_device_name(0), "runs": runs,
          "register_tile_bits_equal_across_checkouts": same})
    require(same, "the register-tile kernel's bits differ between the "
            "checkouts on kernel_vs_plain's inputs")
    return 0


def main() -> int:
    if len(sys.argv) > 1:
        return ab_main(sys.argv[1:])
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
    errs.update(phase_lanes_vs_plain(torch, dev))
    errs.update(phase_wide_vs_plain(torch, dev))
    phase_paper_s5(torch, cfg)
    phase_zoo(torch, dev)
    phase_tol(torch)
    phase_wide_features(torch, dev)
    phase_lane_faults(torch, dev)
    phase_federated_s5(torch, dev)
    cert_entry = phase_serving_s5(torch, dev)
    errs["sym_pinv"] = cert_entry["max_abs_err"]
    # one full-size graph for every solve: the layout is planned once
    t0 = time.perf_counter()
    graph, data, w_true, assign = make_clustered(FULL_NODES, seed=0,
                                                 device=dev)
    others = loss_instances(graph, assign, seed=1)
    gen_s = time.perf_counter() - t0
    big = Problem.create(graph, data, 1e-3)
    entry, full_size_rate, plan_s, cert_launches = phase_full_size(
        torch, dev, cfg, big, w_true, gen_s)
    kernels = [entry, dict(cert_entry, launches=cert_launches)]
    # the wide phase's λ path holds ~54 GB at its peak: before the tol
    # engines' captured graphs keep their memory pool, from an emptied
    # allocator cache
    torch.cuda.empty_cache()
    kernels += phase_wide_full_size(torch, dev, graph, assign)
    torch.cuda.empty_cache()
    phase_obs_full_size(torch, cfg, big, w_true, full_size_rate)
    phase_federated_full_size(torch, big, w_true)
    kernels += phase_full_size_variants(torch, dev, cfg, big, w_true, others)
    full_tol = phase_full_size_tol(torch, cfg, big)
    phase_tol_engine(torch, big, full_tol)
    phase_serving_full_size(torch, big, assign, full_tol, plan_s)
    kernels += phase_unfused_full_size(torch, dev, cfg, big, w_true)
    kernels += phase_path_full_size(torch, dev, big, w_true, others)
    kernels += phase_path_tol_full_size(torch, dev, big)
    kernels += phase_many_full_size(torch, dev, graph, assign)
    errs["fused_pd_step[sharded]"] = phase_sharded_s5(torch, dev)
    kernels.append(phase_sharded_full_size(torch, dev))
    phase_sharded_ranks(torch, dev)
    del big, others, data, w_true
    torch.cuda.empty_cache()
    kernels += phase_wide_streamed(torch, dev)
    kernels += phase_many_samples_full_size(torch, dev)
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

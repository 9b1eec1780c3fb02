"""Execution backends for the port's solver — thin drivers over the engine.

Every backend runs the canonical primal-dual iteration
(:func:`repro_torch.engine.step.pd_step`, paper eqs. 14-15) and returns
one :class:`~repro_torch.api.problem.SolveResult`:

  * ``dense``  — a Python loop over the dense executor (any device; the
                 yardstick),
  * ``pallas`` — the port's kernels; the name is the reference's, so one
                 ``SolverConfig`` drives both packages.  Fused (the
                 default on the card): the fused primal-dual kernel over
                 the edge-blocked layout (``kernels/pd_step.py``).
                 Unfused: the dense loop with the dual clip through
                 ``kernels.ops.tv_prox`` (TV regularizer) and the squared
                 loss's affine prox through ``kernels.ops.batched_affine``.
                 Each op is the CUDA kernel on the card and its plain
                 version on the CPU.

``SolverConfig.tol`` stops a solve at the first metric block whose
eq.-11 residual is <= tol, with the test kept on the device
(:func:`repro_torch.engine.loop.device_loop`): a tol solve makes exactly
one device->host transfer, the :func:`~repro_torch.engine.loop.
device_fetch` of its stopping iteration.  ``dtype="bfloat16"`` is a
storage policy of the fused path (bf16 state and prox parameters, f32
arithmetic); the dense and unfused paths run float32 and refuse it.

Lanes.  ``api.solver.solve_path`` and ``solve_many`` run many problems
as one solve over a leading lane axis, where the reference vmaps its
engines: a lambda path (one graph, one lambda per lane; the dense and
unfused engines through ``_solve_dense_path``, the fused one through
``_solve_fused`` with ``lams``) and a batch of shape-matched problems
(``solve_dense_batched``: graphs, data and lambdas per lane).  The
kernels take the lane axis in one launch each (the fused kernel in
groups of at most ``kernels.pd_step.MAX_LANES`` lanes).

``federated`` runs the round-based message-passing runtime
(``repro_torch.federated``) with ``SolverConfig.federated``'s policies.
``sharded`` and ``sharded_fused`` partition the graph over the ranks of
a mesh (``core.mesh``; SPMD: every rank calls ``Solver.run`` with the
whole problem and gets the same result): the halo-exchange engine step,
and the fused kernel on each shard's own edge-blocked layout with a
dual halo refresh between shards (``core.distributed``).
"""
from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.losses import Loss, SquaredLoss
from repro_torch.api.problem import Problem, SolveResult, SolverConfig
from repro_torch.api.regularizers import TotalVariation
from repro_torch.core.graph import (batched_incidence_apply,
                                    graph_signal_mse, lane_signal_mse,
                                    plan_edge_blocks)
from repro_torch.core.losses import NodeData
from repro_torch.core.partition import gather_padded
from repro_torch.engine import (BatchedDenseExecutor, DenseExecutor,
                                certificate, device_fetch, device_loop,
                                pd_residual, scan_solve)
from repro_torch.engine import pd_step as engine_pd_step
from repro_torch.kernels import ops, pd_step as pd_kernel

BACKENDS: dict[str, Callable] = {}


def register_backend(name: str):
    """Decorator adding ``fn(problem, config, *, w0, u0, w_true)``."""
    def deco(fn):
        BACKENDS[name] = fn
        return fn
    return deco


def get_backend(name: str) -> Callable:
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {sorted(BACKENDS)}")


def _diagnostics(problem: Problem, w, u, config: SolverConfig) -> dict:
    """Certificate per config — empty for throwaway (warm-phase) solves."""
    if not config.compute_diagnostics:
        return {}
    return certificate(problem, w, u)


def _check_cadence(config: SolverConfig) -> None:
    if config.num_iters % config.metric_every:
        raise ValueError(
            f"metric_every={config.metric_every} must divide "
            f"num_iters={config.num_iters}")


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _storage_dtype(config: SolverConfig, *, fused: bool) -> torch.dtype:
    """Validate ``SolverConfig.dtype`` for the chosen execution path.

    bf16 is a *fused-path* storage policy (state and prox parameters
    stored bf16, arithmetic f32 — see ``kernels.ref.pd_window_step``);
    every other path runs f32 and refuses a reduced dtype loudly instead
    of silently ignoring it.
    """
    name = config.dtype
    if isinstance(name, torch.dtype):
        name = str(name).removeprefix("torch.")
    if name not in _DTYPES:
        raise ValueError(
            f"unsupported SolverConfig.dtype {config.dtype!r}; use "
            "'float32' or 'bfloat16'")
    if name == "bfloat16" and not fused:
        raise NotImplementedError(
            "SolverConfig.dtype='bfloat16' is a storage policy of the "
            "fused pallas path; this path runs float32 (use "
            "backend='pallas' with fused=True, or dtype='float32')")
    return _DTYPES[name]


def _with_iterations(diag: dict, config: SolverConfig,
                     iterations: int) -> dict:
    """Record iterations-to-tolerance on tol runs (host-side ints)."""
    if config.tol is not None and diag is not None:
        diag = dict(diag)
        diag["iterations"] = int(iterations)
    return diag


def _fetch_stop(its, traces: tuple, config: SolverConfig):
    """The tol solve's single device->host transfer (the stopping
    iteration), then the traces truncated to the blocks that ran."""
    iterations = device_fetch(its)
    nb = iterations // config.metric_every
    return iterations, tuple(t[:nb] for t in traces)


def _initial_state(problem: Problem, w0, u0):
    """(w0, u0) as f32 tensors on the problem's device (zeros if None)."""
    V, n, dev = problem.num_nodes, problem.num_features, problem.device
    w0 = (torch.zeros((V, n), dtype=torch.float32, device=dev) if w0 is None
          else torch.as_tensor(w0, dtype=torch.float32, device=dev))
    u0 = (torch.zeros((problem.graph.num_edges, n), dtype=torch.float32,
                      device=dev) if u0 is None
          else torch.as_tensor(u0, dtype=torch.float32, device=dev))
    return w0, u0


def lane_values(values, device) -> torch.Tensor:
    """One float32 per lane on ``device`` from host values, made on the
    device (``torch.full``): no host-to-device copy, which would
    synchronize the card."""
    return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                   device=device) for v in values])


#: the most float32 elements one lane group of :func:`lane_metrics`
#: gathers at once (its D w, its predictions): 1 GiB
LANE_METRICS_ELEMENTS = 1 << 28


def lane_metrics(loss: Loss, reg, src, dst, weights, data, lam,
                 w_true) -> Callable:
    """``metrics(w_b) -> (objective (L,), mse (L,))`` of every lane at
    once, as the reference vmaps its metric function: on the lane-stacked
    state w_b (L, V, n), with ``lam`` (L,), the edge ends ``src`` /
    ``dst`` and ``weights`` shared (E,) or per lane (L, E) and ``data``
    shared or stacked.  MSE is the paper's eq. (24) over the unlabeled
    (test) nodes of ``w_true`` (V, n), 0 without it.  Every sum runs in
    ``core.graph.ordered_sum``'s order, so lane l's values are the bits
    of a one-lane evaluation (:func:`make_metrics_fn`): a lane's trace is
    the one its own solve records.  Lanes whose edge differences and
    predictions pass ``LANE_METRICS_ELEMENTS`` together are evaluated in
    groups of lanes (a lane's values do not depend on its group)."""
    unlabeled = 1.0 - data.labeled_mask
    stacked = src.ndim == 2

    def group(w_b, sl):
        def lanes_of(t):
            return t[sl] if stacked else t
        d = batched_incidence_apply(lanes_of(src), lanes_of(dst), w_b)
        data_g = data if not stacked else NodeData(*(
            getattr(data, k)[sl]
            for k in ("x", "y", "sample_mask", "labeled_mask")))
        obj = (loss.empirical_error(data_g, w_b)
               + reg.lane_value(d, lanes_of(weights), lam[sl]))
        if w_true is None:
            mse = torch.zeros(w_b.shape[:1], dtype=torch.float32,
                              device=w_b.device)
        else:
            mse = lane_signal_mse(w_b, w_true, unlabeled)
        return obj, mse

    def metrics(w_b):
        lanes, n = w_b.shape[0], w_b.shape[-1]
        per_lane = max(src.shape[-1] * n, data.x.shape[-3] * data.x.shape[-2])
        size = max(1, LANE_METRICS_ELEMENTS // per_lane)
        if size >= lanes:
            return group(w_b, slice(None))
        parts = [group(w_b[g:g + size], slice(g, g + size))
                 for g in range(0, lanes, size)]
        return tuple(torch.cat(col) for col in zip(*parts))

    return metrics


def _batched_certificate(problems: list, w_b, u_b) -> dict:
    """The eq.-11 certificate of each lane (``problems[i]`` at ``w_b[i]``,
    ``u_b[i]``), stacked: ``{name: (L,)}`` (the reference vmaps
    ``certificate``)."""
    rows = [certificate(p, w_b[i], u_b[i]) for i, p in enumerate(problems)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


# ---------------------------------------------------------------------------
# Dense backend (Python loop over the dense executor)
# ---------------------------------------------------------------------------

def make_metrics_fn(loss: Loss, reg, graph, data, lam, w_true):
    """``metrics(w) -> (objective, mse)`` — the one trace formula: one
    lane of :func:`lane_metrics`, so a lambda path's lane records the
    trace of its own solve bit for bit.

    MSE is the paper's eq. (24) over the unlabeled (test) nodes, 0 when
    no ground truth is supplied.
    """
    lanes = lane_metrics(loss, reg, graph.src, graph.dst, graph.weights,
                         data, lane_values([lam], graph.device), w_true)

    def metrics(w):
        obj, mse = lanes(w[None])
        return obj[0], mse[0]

    return metrics


def _dense_scan_impl(problem: Problem, w0, u0, w_true, *, num_iters: int,
                     rho: float, metric_every: int, clip_fn, affine_fn,
                     record_residual: bool = False):
    """Run Algorithm 1 on the dense executor, recording metrics on a
    cadence, with the kernel hooks ``clip_fn`` / ``affine_fn`` wired into
    the dual clip and the affine prox.  Returns ``(w, u, obj_trace,
    mse_trace, res_trace)``."""
    graph, data, lam = problem.graph, problem.data, problem.lam
    loss, reg = problem.loss, problem.regularizer
    tau = graph.primal_stepsizes()
    sigma = graph.dual_stepsizes()
    prox = loss.make_prox(data, tau, affine_fn=affine_fn)
    metrics = make_metrics_fn(loss, reg, graph, data, lam, w_true)
    executor = DenseExecutor(graph)

    def run_block(state, iters):
        del iters                      # dense blocks advance one step
        w, u = state
        return engine_pd_step(executor, prox, reg, lam, tau, sigma, w, u,
                              rho=rho, clip_fn=clip_fn)

    residual_fn = None
    if record_residual:
        def residual_fn(prev, new):
            return pd_residual(tau, sigma, prev[0], prev[1], new[0],
                               new[1])

    (w, u), traces = scan_solve(
        run_block, lambda s: metrics(s[0]), (w0, u0),
        num_iters=num_iters, metric_every=metric_every,
        residual_fn=residual_fn)
    if record_residual:
        (obj_trace, mse_trace), res_trace = traces
    else:
        (obj_trace, mse_trace), res_trace = traces, None
    return w, u, obj_trace, mse_trace, res_trace


def _dense_block_fn(problem: Problem, w_true, params, *, rho: float,
                    metric_every: int, clip_fn, affine_fn):
    """Build ``run_block(state, active)`` for the device-resident tol
    loop: ``metric_every`` engine steps, metrics, and the block-max
    residual.

    ``params`` is the loss's prox parameters, set up once per solve by
    the caller (None falls back to ``make_prox``).  The dense step has
    no stop word: where ``active`` is clear the block's result is
    dropped (``torch.where``), which only the plain loop
    (``engine.loop.device_loop_plain``) asks of it; ``device_loop``
    runs no block after the stop.
    """
    graph, data, lam = problem.graph, problem.data, problem.lam
    loss, reg = problem.loss, problem.regularizer
    tau = graph.primal_stepsizes()
    sigma = graph.dual_stepsizes()
    if params is None:
        prox = loss.make_prox(data, tau, affine_fn=affine_fn)
    else:
        def prox(v):
            return loss.prox_apply(params, v, affine_fn=affine_fn)
    metrics = make_metrics_fn(loss, reg, graph, data, lam, w_true)
    executor = DenseExecutor(graph)

    def run_block(state, active):
        w, u = state
        res = None
        for _ in range(metric_every):
            w_n, u_n = engine_pd_step(executor, prox, reg, lam, tau, sigma,
                                      w, u, rho=rho, clip_fn=clip_fn)
            r = pd_residual(tau, sigma, w, u, w_n, u_n)
            res = r if res is None else torch.maximum(res, r)
            w, u = w_n, u_n
        w = torch.where(active, w, state[0])
        u = torch.where(active, u, state[1])
        obj, mse = metrics(w)
        return (w, u), (obj, mse, res), res

    return run_block


def _solve_dense(problem: Problem, config: SolverConfig, *, w0=None, u0=None,
                 w_true=None, clip_fn=None, affine_fn=None) -> SolveResult:
    _check_cadence(config)
    _storage_dtype(config, fused=False)
    w0, u0 = _initial_state(problem, w0, u0)
    if config.tol is None or config.num_iters == 0:
        w, u, obj, mse, res = _dense_scan_impl(
            problem, w0, u0, w_true, num_iters=config.num_iters,
            rho=config.rho, metric_every=config.metric_every,
            clip_fn=clip_fn, affine_fn=affine_fn,
            record_residual=config.record_residual)
        iterations = config.num_iters
    else:
        # per-solve prox setup happens once, not once per block
        try:
            params = problem.loss.prox_setup(
                problem.data, problem.graph.primal_stepsizes())
        except NotImplementedError:
            params = None
        run_block = _dense_block_fn(
            problem, w_true, params, rho=config.rho,
            metric_every=config.metric_every, clip_fn=clip_fn,
            affine_fn=affine_fn)
        (w, u), traces, its = device_loop(
            run_block, (w0, u0), num_iters=config.num_iters,
            metric_every=config.metric_every, tol=config.tol)
        iterations, (obj, mse, res) = _fetch_stop(its, traces, config)
    diag = _with_iterations(_diagnostics(problem, w, u, config), config,
                            iterations)
    return SolveResult(w=w, u=u, objective=obj,
                       mse=None if w_true is None else mse,
                       lam=problem.lam, diagnostics=diag, residual=res)


def resolve_kernel_hooks(problem: Problem, config: SolverConfig,
                         use_pallas: bool):
    """(clip_fn, affine_fn) for a dense-engine run.

    Caller-supplied hooks from the config always win; the pallas backend
    fills unset ones with the port's kernels (the dual clip only applies
    to the TV regularizer, the affine map to the squared loss).
    """
    clip_fn, affine_fn = config.clip_fn, config.affine_fn
    if use_pallas:
        if clip_fn is None and isinstance(problem.regularizer,
                                          TotalVariation):
            clip_fn = ops.tv_prox
        if affine_fn is None and isinstance(problem.loss, SquaredLoss):
            affine_fn = ops.batched_affine
    return clip_fn, affine_fn


@register_backend("dense")
def solve_dense(problem: Problem, config: SolverConfig, *, w0=None, u0=None,
                w_true=None) -> SolveResult:
    clip_fn, affine_fn = resolve_kernel_hooks(problem, config, False)
    return _solve_dense(problem, config, w0=w0, u0=u0, w_true=w_true,
                        clip_fn=clip_fn, affine_fn=affine_fn)


# ---------------------------------------------------------------------------
# Fused pallas path: edge-blocked layout + fused primal-dual kernel
# ---------------------------------------------------------------------------

# layouts are planned once per graph object (EmpiricalGraph hashes by
# identity, so a WeakKeyDictionary caches per object without retaining
# graphs).  Attaching via graph.with_layout() bypasses this cache.
_LAYOUT_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _graph_layout(graph, window_hint=None):
    """Plan (or fetch) the graph's edge-blocked layout.

    ``window_hint = (num_features, param_floats, itemsize, cap)`` feeds
    the block-size auto-tuner in ``plan_edge_blocks``.  The cache keeps
    whichever layout was planned first for a graph.
    """
    if graph.layout is not None:
        return graph.layout
    layout = _LAYOUT_CACHE.get(graph)
    if layout is None:
        layout = plan_edge_blocks(graph, window_hint=window_hint)
        _LAYOUT_CACHE[graph] = layout
    return layout


def _fused_enabled(problem: Problem, config: SolverConfig) -> bool:
    """Fused is the default on the card (which takes the TPU's role in
    the reference's gate); flag/env opt-out and opt-in."""
    if config.fused is not None:
        return bool(config.fused)
    env = os.environ.get("REPRO_FUSED")
    if env is not None:
        return env.strip().lower() not in ("", "0", "false", "no", "off")
    return problem.device.type == "cuda"


def _fused_supported(problem: Problem, config: SolverConfig) -> bool:
    """The fused step needs windowable prox parameters and an
    edge-elementwise dual resolvent; on the card the loss must also run
    inside the kernel (``kernel_safe``: every registered loss does, so
    only a loss without ``prox_setup`` or a ``kernel_safe=False`` one
    runs the unfused path there, as on the reference's TPU).  Custom
    kernel hooks disable fusion (they target the unfused engine)."""
    loss, reg = problem.loss, problem.regularizer
    has_setup = type(loss).prox_setup is not Loss.prox_setup
    kernel_ok = problem.device.type == "cpu" or loss.kernel_safe
    return (has_setup and kernel_ok and reg.fusable
            and config.clip_fn is None and config.affine_fn is None)


def _fused_window_cap() -> int:
    """Max window bytes the layout may plan.  The reference caps it at
    the TPU's VMEM budget on a TPU and leaves it effectively uncapped
    elsewhere; the CUDA kernel reads the layout from device memory, so
    the port keeps the uncapped value (the env knob keeps its meaning)."""
    env = os.environ.get("REPRO_FUSED_MAX_WINDOW_BYTES")
    if env:
        return int(env)
    return 1 << 62


def _fused_window_fits(problem: Problem,
                       config: SolverConfig | None = None, *,
                       lanes: int = 1) -> bool:
    """Plan (or fetch) the graph's layout and check the window cap.

    The estimate is dtype-aware, as the reference's: the storage
    policy's itemsize scales the state and prox-parameter bytes
    (``EdgeBlockLayout.window_bytes``) and feeds the block-size
    auto-tuner.  On the card the kernel takes any feature count and any
    samples a node (staging the prox parameters or streaming them,
    ``kernels.pd_step.plan_variant``); what it cannot take, the
    counterpart of the TPU's VMEM cap, is a wide logistic node whose
    Hessian passes one warp's shared memory (n > 336,
    ``kernels.pd_step.kernel_takes``).  Such a problem runs unfused.
    """
    num_samples = problem.data.x.shape[-2]
    try:
        param_floats = problem.loss.prox_param_floats(
            num_samples, problem.num_features)
    except NotImplementedError:
        return False
    if problem.device.type == "cuda" and not pd_kernel.kernel_takes(
            problem.loss, problem.num_features, num_samples, lanes):
        return False
    itemsize = 4
    if config is not None:
        itemsize = _storage_dtype(config, fused=True).itemsize
    cap = _fused_window_cap()
    lt = _graph_layout(problem.graph, window_hint=(
        problem.num_features, param_floats, itemsize, cap))
    return lt.window_bytes(problem.num_features, param_floats=param_floats,
                           itemsize=itemsize) <= cap


def _should_fuse(problem: Problem, config: SolverConfig, *,
                 lanes: int = 1) -> bool:
    """The one fused-dispatch gate; ``lanes`` the lambdas of a path, of
    which one launch takes at most ``kernels.pd_step.MAX_LANES``."""
    return (_fused_enabled(problem, config)
            and _fused_supported(problem, config)
            and _fused_window_fits(problem, config,
                                   lanes=min(lanes, pd_kernel.MAX_LANES)))


def _fused_setup(graph, data, lam, w_true, *, loss, reg, layout,
                 dtype: torch.dtype = torch.float32):
    """Per-solve prep for the fused engine: layout padding, stepsizes,
    windowed prox parameters, and the metric fn (original node order,
    the dense engine's formulas, in f32).

    ``dtype`` is the storage policy: float prox-parameter stores are cast
    to it, while tau, sigma, la and src/dst stay f32 or int.  ``lam`` a
    sequence of host floats is a lambda path: la is then (L, nb*EB, 1),
    one column per lane, and the metric fn maps (L, rows, n) to per-lane
    (L,) traces; everything else is shared by the lanes.
    """
    lt = layout
    # the paper-eq.-13 stepsizes come from the one source of truth
    # (EmpiricalGraph), gathered into layout order (pad nodes: tau 1)
    tau_l = gather_padded(graph.primal_stepsizes(), lt.node_perm, fill=1.0)
    sig_l = torch.full((lt.edges_pad,), 0.5, dtype=torch.float32,
                       device=graph.device)
    sig_l[lt.edge_pos.long()] = graph.dual_stepsizes()

    def gather_nodes(a):
        return gather_padded(a, lt.node_perm)

    data_l = NodeData(x=gather_nodes(data.x), y=gather_nodes(data.y),
                      sample_mask=gather_nodes(data.sample_mask),
                      labeled_mask=gather_nodes(data.labeled_mask))
    params = loss.prox_setup(data_l, tau_l)
    pkeys = tuple(sorted(params))
    params_s = tuple(
        lt.pad_node_store(params[k]).to(
            dtype if params[k].is_floating_point() else params[k].dtype)
        .contiguous() for k in pkeys)
    tau_s = lt.pad_node_store(tau_l[:, None])
    src2, dst2 = lt.src[:, None], lt.dst[:, None]
    sig2 = sig_l[:, None]
    node_inv = lt.node_inv.long()
    if isinstance(lam, (int, float)):
        la2 = (lam * lt.weights)[:, None]
        metrics_fn = make_metrics_fn(loss, reg, graph, data, lam, w_true)
    else:
        lams = lane_values(lam, graph.device)
        la2 = (lams[:, None] * lt.weights)[..., None]
        metrics_fn = lane_metrics(loss, reg, graph.src, graph.dst,
                                  graph.weights, data, lams, w_true)

    def metrics(w_l):
        return metrics_fn(w_l[..., node_inv, :].to(torch.float32))

    return (params_s, pkeys, tau_l, tau_s, sig_l, sig2, src2, dst2, la2,
            metrics)


def _fused_run_iters(lt, inc_e, inc_s, params_s, pkeys, tau_s, src2, dst2,
                     sig2, la2, *, loss, reg, rho,
                     compute_residual: bool = False):
    """Build ``run_iters(state, iters, active=None)`` advancing the padded
    stores.

    The stores are the solve's own tensors: each launch writes its owned
    rows in place (``out`` = the owned rows; the halo padding rows are
    never written), as the reference does with a ``dynamic_update_slice``.
    With ``compute_residual`` each call also returns the f32 eq.-11
    residual the kernel accumulated: ``(state, residual)``.  ``active`` is
    the tol solve's stop word (see ``kernels.ref.fused_pd_step_ref``).
    Lane-stacked stores (a lambda path) advance every lane in each call:
    one launch for each group of at most ``kernels.pd_step.MAX_LANES``
    lanes, in lane order.  Lanes are independent, so a lane's result does
    not depend on its group.
    """
    bv, eb = lt.block_nodes, lt.block_edges
    kn, klo, khi = lt.kn, lt.klo, lt.khi
    nodes, edges = lt.num_blocks * bv, lt.num_blocks * eb

    def launch(w_store, u_store, la, iters, active):
        return ops.pd_step(
            w_store, u_store, inc_e, inc_s, params_s, tau_s, src2, dst2,
            sig2, la, loss=loss, reg=reg, pkeys=pkeys, block_nodes=bv,
            block_edges=eb, kn=kn, klo=klo, khi=khi, rho=rho, iters=iters,
            compute_residual=compute_residual, active=active,
            out=(w_store[..., :nodes, :],
                 u_store[..., klo * eb:klo * eb + edges, :]),
            incidence=lt.compact)

    def run_iters(state, iters, active=None):
        w_store, u_store = state
        if w_store.ndim == 2:
            outs = [launch(w_store, u_store, la2, iters, active)]
        else:
            cap = pd_kernel.MAX_LANES
            outs = [launch(w_store[g:g + cap], u_store[g:g + cap],
                           la2[g:g + cap], iters, active)
                    for g in range(0, w_store.shape[0], cap)]
        if not compute_residual:
            return state
        res = [o[2] for o in outs]
        return state, res[0] if w_store.ndim == 2 else torch.cat(res)

    return run_iters


def _fused_stores(lt, w0_l, u0_l, dtype):
    """The padded (w_store, u_store) of a solve in the storage dtype; with
    a leading lane axis, every lane's."""
    eb, n = lt.block_edges, w0_l.shape[-1]
    lead = tuple(w0_l.shape[:-2])
    zeros = u0_l.new_zeros
    w_store0 = torch.cat([w0_l, zeros(lead + ((lt.kn - 1) * lt.block_nodes,
                                              n))], dim=-2).to(dtype)
    u_store0 = torch.cat([zeros(lead + (lt.klo * eb, n)), u0_l,
                          zeros(lead + (lt.khi * eb, n))], dim=-2).to(dtype)
    return w_store0, u_store0


def _owned(lt, state):
    """The owned rows (w_l, u_l) of the padded stores (of every lane)."""
    w_store, u_store = state
    lo = lt.klo * lt.block_edges
    return (w_store[..., :lt.nodes_pad, :],
            u_store[..., lo:lo + lt.edges_pad, :])


def _fused_scan_impl(problem: Problem, w0_l, u0_l, w_true, *, layout,
                     num_iters: int, rho: float, metric_every: int,
                     record_residual: bool = False,
                     dtype: torch.dtype = torch.float32, lams=None):
    """The fused engine: loop the fused PD step over the edge-blocked
    layout, recording metrics on the cadence.  A single-block layout
    runs each metric block as one launch (``iters=metric_every``).
    ``dtype`` is the storage policy of the state and the prox
    parameters.  ``lams`` (host floats) runs a lambda path: the state
    then carries a lane axis, every launch advances all lanes, and the
    traces are (T, L).  Returns owned-layout ``(w_l, u_l, obj, mse,
    res)``, the state in the storage dtype."""
    lt = layout
    (params_s, pkeys, tau_l, tau_s, sig_l, sig2, src2, dst2, la2,
     metrics) = _fused_setup(problem.graph, problem.data,
                             problem.lam if lams is None else lams,
                             w_true, loss=problem.loss,
                             reg=problem.regularizer, layout=lt, dtype=dtype)

    run_iters = _fused_run_iters(
        lt, lt.pad_node_store(lt.inc_edges), lt.pad_node_store(lt.inc_signs),
        params_s, pkeys, tau_s, src2, dst2, sig2, la2, loss=problem.loss,
        reg=problem.regularizer, rho=rho)

    run_block, residual_fn = run_iters, None
    if record_residual:
        # the residual reads both ends of a block's closing step, so the
        # in-place step works on a copy of the state it is given
        def run_block(state, iters):
            return run_iters(tuple(t.clone() for t in state), iters)

        def residual_fn(prev, new):
            f32 = torch.float32
            w_p, u_p = _owned(lt, prev)
            w_n, u_n = _owned(lt, new)
            return pd_residual(tau_l, sig_l, w_p.to(f32), u_p.to(f32),
                               w_n.to(f32), u_n.to(f32),
                               lanes=lams is not None)

    state, traces = scan_solve(
        run_block, lambda s: metrics(s[0][..., :lt.nodes_pad, :]),
        _fused_stores(lt, w0_l, u0_l, dtype), num_iters=num_iters,
        metric_every=metric_every, multi_iter_block=(lt.num_blocks == 1),
        residual_fn=residual_fn)
    if record_residual:
        (obj_trace, mse_trace), res_trace = traces
    else:
        (obj_trace, mse_trace), res_trace = traces, None
    w_l, u_l = _owned(lt, state)
    return w_l, u_l, obj_trace, mse_trace, res_trace


def _fused_tol_impl(problem: Problem, w0_l, u0_l, w_true, *, layout,
                    num_iters: int, rho: float, metric_every: int,
                    tol: float, dtype: torch.dtype = torch.float32):
    """The fused tol engine: :func:`device_loop` over metric blocks with
    the eq.-11 residual computed in the kernel and the stop word read by
    every launch, so the stopping signal never leaves the device.  A
    single-block layout runs each metric block as one launch
    (``iters=metric_every``) whose running-max residual rides the
    kernel's carry; otherwise the block's launches each return their
    residual and the block takes the max.  Returns owned-layout
    ``(w_l, u_l, traces, iterations)`` with ``iterations`` on the
    device."""
    lt = layout
    (params_s, pkeys, _, tau_s, _, sig2, src2, dst2, la2, metrics) = \
        _fused_setup(problem.graph, problem.data, problem.lam, w_true,
                     loss=problem.loss, reg=problem.regularizer, layout=lt,
                     dtype=dtype)
    run_iters = _fused_run_iters(
        lt, lt.pad_node_store(lt.inc_edges), lt.pad_node_store(lt.inc_signs),
        params_s, pkeys, tau_s, src2, dst2, sig2, la2, loss=problem.loss,
        reg=problem.regularizer, rho=rho, compute_residual=True)

    def run_block(state, active):
        if lt.num_blocks == 1:
            state, res = run_iters(state, metric_every, active)
        else:
            res = None
            for _ in range(metric_every):
                state, r = run_iters(state, 1, active)
                res = r if res is None else torch.maximum(res, r)
        obj, mse = metrics(state[0][:lt.nodes_pad])
        return state, (obj, mse, res), res

    state, traces, its = device_loop(
        run_block, _fused_stores(lt, w0_l, u0_l, dtype),
        num_iters=num_iters, metric_every=metric_every, tol=tol)
    w_l, u_l = _owned(lt, state)
    return w_l, u_l, traces, its


def _solve_fused(problem: Problem, config: SolverConfig, *, w0=None,
                 u0=None, w_true=None, lams=None) -> SolveResult:
    """Solve via the fused PD kernel on the edge-blocked graph layout.

    ``lams`` (host floats, fixed budget only) solves a lambda path in
    one: every launch advances all lanes, each from the shared ``w0``
    (V, n) and its own ``u0`` (L, E, n); the result's leaves then carry
    the lane axis (the reference vmaps this function)."""
    _check_cadence(config)
    dtype = _storage_dtype(config, fused=True)
    lt = _graph_layout(problem.graph)
    n, dev = problem.num_features, problem.device
    lead = () if lams is None else (len(lams),)

    w0_l = torch.zeros(lead + (lt.nodes_pad, n), dtype=torch.float32,
                       device=dev)
    if w0 is not None:
        w0_l[...] = gather_padded(torch.as_tensor(
            w0, dtype=torch.float32, device=dev), lt.node_perm)
    u0_l = torch.zeros(lead + (lt.edges_pad, n), dtype=torch.float32,
                       device=dev)
    edge_pos = lt.edge_pos.long()
    if u0 is not None:
        u0_l[..., edge_pos, :] = (torch.as_tensor(u0, dtype=torch.float32,
                                                  device=dev)
                                  * lt.edge_flip[:, None])

    run = dict(layout=lt, num_iters=config.num_iters, rho=config.rho,
               metric_every=config.metric_every, dtype=dtype)
    if config.tol is None or config.num_iters == 0:
        w_l, u_l, obj, mse, res = _fused_scan_impl(
            problem, w0_l, u0_l, w_true,
            record_residual=config.record_residual, lams=lams, **run)
        iterations = config.num_iters
    else:
        if lams is not None:
            raise ValueError("a tol lambda path runs the masked sweep "
                             "(api.solver._solve_path_masked)")
        w_l, u_l, traces, its = _fused_tol_impl(
            problem, w0_l, u0_l, w_true, tol=config.tol, **run)
        iterations, (obj, mse, res) = _fetch_stop(its, traces, config)
    f32 = torch.float32
    w = w_l[..., lt.node_inv.long(), :].to(f32)
    u = u_l[..., edge_pos, :].to(f32) * lt.edge_flip[:, None]
    if lams is not None:
        return _lane_result(problem, lams, config, w, u, obj, mse, res,
                            w_true)
    diag = _with_iterations(_diagnostics(problem, w, u, config), config,
                            iterations)
    return SolveResult(w=w, u=u, objective=obj,
                       mse=None if w_true is None else mse,
                       lam=problem.lam, diagnostics=diag, residual=res)


def _lane_result(problem: Problem, lams, config: SolverConfig, w, u, obj,
                 mse, res, w_true) -> SolveResult:
    """A lambda path's result: leaves with a leading lane axis, traces
    (L, T), the lambdas as a host tensor, per-lane certificates."""
    diag = {}
    if config.compute_diagnostics:
        diag = _batched_certificate(
            [problem.with_lam(float(v)) for v in lams], w, u)
    return SolveResult(
        w=w, u=u, objective=obj.T, mse=None if w_true is None else mse.T,
        lam=torch.from_numpy(np.asarray(lams, np.float32)),
        diagnostics=diag, residual=None if res is None else res.T)


# ---------------------------------------------------------------------------
# Lane-stacked dense engine: a lambda path, or a batch of problems
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Lanes:
    """L problems that step together on the lane-stacked dense executor:
    one per lambda of a path (one graph, data and prox parameters shared
    by every lane) or a batch of shape-matched problems (each lane its
    own graph, data and parameters).  ``lam`` is (L, 1); ``tau`` /
    ``sigma`` broadcast against the (L, V, n) / (L, E, n) state;
    ``metrics`` maps (L, V, n) to per-lane (L,) traces."""

    executor: BatchedDenseExecutor
    loss: Loss
    reg: object
    lam: torch.Tensor
    tau: torch.Tensor
    sigma: torch.Tensor
    params: dict
    metrics: Callable


def _path_lanes(problem: Problem, lams, w_true, params=None) -> _Lanes:
    """The lanes of a lambda path on ``problem`` (``lams`` host floats);
    ``params`` the loss's prox parameters, set up once (shared)."""
    graph, data = problem.graph, problem.data
    if params is None:
        params = problem.loss.prox_setup(data, graph.primal_stepsizes())
    lam = lane_values(lams, problem.device)
    return _Lanes(
        executor=BatchedDenseExecutor.shared(graph), loss=problem.loss,
        reg=problem.regularizer, lam=lam[:, None],
        tau=graph.primal_stepsizes(), sigma=graph.dual_stepsizes(),
        params=params, metrics=lane_metrics(
            problem.loss, problem.regularizer, graph.src, graph.dst,
            graph.weights, data, lam, w_true))


def _batched_setup_impl(problems: list) -> tuple:
    """The stacked set-up of a batch of shape-matched problems: the
    lane-stacked executor, data, stepsizes and prox parameters (one
    ``prox_setup`` over the stacked data; the reference vmaps it)."""
    graphs = [p.graph for p in problems]
    data_b = _stacked_data(problems)
    tau_b = torch.stack([g.primal_stepsizes() for g in graphs])
    sigma_b = torch.stack([g.dual_stepsizes() for g in graphs])
    params_b = problems[0].loss.prox_setup(data_b, tau_b)
    return BatchedDenseExecutor.stacked(graphs), tau_b, sigma_b, params_b


def _stacked_data(problems: list) -> NodeData:
    """The problems' data stacked along a leading lane axis."""
    return NodeData(*(torch.stack([getattr(p.data, k) for p in problems])
                      for k in ("x", "y", "sample_mask", "labeled_mask")))


def _many_lanes(problems: list) -> _Lanes:
    """The lanes of ``solve_many``'s batch: one problem per lane."""
    executor, tau_b, sigma_b, params_b = _batched_setup_impl(problems)
    p0 = problems[0]
    lam = lane_values([p.lam for p in problems], p0.device)
    graphs = [p.graph for p in problems]
    return _Lanes(
        executor=executor, loss=p0.loss, reg=p0.regularizer,
        lam=lam[:, None], tau=tau_b[..., None], sigma=sigma_b[..., None],
        params=params_b, metrics=lane_metrics(
            p0.loss, p0.regularizer, torch.stack([g.src for g in graphs]),
            torch.stack([g.dst for g in graphs]),
            torch.stack([g.weights for g in graphs]),
            _stacked_data(problems), lam, None))


def _lane_step(lanes: _Lanes, state, *, rho: float, clip_fn, affine_fn):
    """One primal-dual step of every lane (the canonical engine step on
    the lane-stacked executor, one lambda per lane)."""
    w, u = state

    def prox(v):
        return lanes.loss.prox_apply(lanes.params, v, affine_fn=affine_fn)

    return engine_pd_step(lanes.executor, prox, lanes.reg, lanes.lam,
                          lanes.tau, lanes.sigma, w, u, rho=rho,
                          clip_fn=clip_fn)


def _lane_block_fn(lanes: _Lanes, *, rho: float, metric_every: int,
                   clip_fn, affine_fn):
    """``advance(state) -> (state, residual (L,))``: one metric block of
    every lane, the residual its per-lane block max."""
    def advance(state):
        res = None
        for _ in range(metric_every):
            new = _lane_step(lanes, state, rho=rho, clip_fn=clip_fn,
                             affine_fn=affine_fn)
            r = pd_residual(lanes.tau, lanes.sigma, *state, *new,
                            lanes=True)
            res = r if res is None else torch.maximum(res, r)
            state = new
        return state, res

    return advance


def _batched_scan_impl(lanes: _Lanes, w0_b, u0_b, *, num_iters: int,
                       rho: float, metric_every: int, clip_fn, affine_fn,
                       record_residual: bool = False):
    """The dense engine over lanes (the reference vmaps
    ``_dense_scan_impl``): ``num_iters`` steps of every lane, metrics on
    the cadence.  Returns ``(w, u, obj, mse, res)`` with (L, T) traces
    (``res`` None unless recorded)."""
    def run_block(state, iters):
        del iters                      # dense blocks advance one step
        return _lane_step(lanes, state, rho=rho, clip_fn=clip_fn,
                          affine_fn=affine_fn)

    residual_fn = None
    if record_residual:
        def residual_fn(prev, new):
            return pd_residual(lanes.tau, lanes.sigma, *prev, *new,
                               lanes=True)

    (w, u), traces = scan_solve(
        run_block, lambda s: lanes.metrics(s[0]), (w0_b, u0_b),
        num_iters=num_iters, metric_every=metric_every,
        residual_fn=residual_fn)
    (obj, mse), res = traces if record_residual else (traces, None)
    return w, u, obj.T, mse.T, None if res is None else res.T


def _batched_tol_impl(lanes: _Lanes, w0_b, u0_b, tol: float, *,
                      num_iters: int, rho: float, metric_every: int,
                      clip_fn, affine_fn):
    """The batched tol engine: :func:`device_loop` over metric blocks of
    every lane, stopping when the *max* residual over the batch is <= tol
    (batch-granular, as the reference: every problem runs the shared
    iteration count, so each certificate holds on its own).  As on the
    dense path, no block runs after the stop.  Returns ``(w, u, traces
    (T, L) each, iterations)`` with ``iterations`` on the device."""
    advance = _lane_block_fn(lanes, rho=rho, metric_every=metric_every,
                             clip_fn=clip_fn, affine_fn=affine_fn)

    def run_block(state, active):
        new, res = advance(state)
        new = tuple(torch.where(active, n_, o_) for n_, o_ in zip(new, state))
        obj, mse = lanes.metrics(new[0])
        return new, (obj, mse, res), torch.max(res)

    state, traces, its = device_loop(
        run_block, (w0_b, u0_b), num_iters=num_iters,
        metric_every=metric_every, tol=tol)
    return state[0], state[1], traces, its


def solve_dense_batched(problems: list, config: SolverConfig, w0_b, u0_b,
                        *, clip_fn=None, affine_fn=None):
    """Solve B shape-matched problems as one lane-stacked dense run (see
    ``api.solver.solve_many`` for the checks and the front end).  With
    ``tol`` set, stopping is batch-granular: the solve stops once the
    max residual over the batch certifies, with one device->host fetch.

    Returns ``(w, u, obj, mse, res, iterations)`` with leading batch axes
    ((B, T) traces; ``res`` None unless tracked)."""
    _check_cadence(config)
    _storage_dtype(config, fused=False)
    lanes = _many_lanes(problems)
    run = dict(num_iters=config.num_iters, rho=config.rho,
               metric_every=config.metric_every, clip_fn=clip_fn,
               affine_fn=affine_fn)
    if config.tol is None or config.num_iters == 0:
        w, u, obj, mse, res = _batched_scan_impl(
            lanes, w0_b, u0_b, record_residual=config.record_residual,
            **run)
        return w, u, obj, mse, res, config.num_iters
    w, u, traces, its = _batched_tol_impl(lanes, w0_b, u0_b, config.tol,
                                          **run)
    iterations, (obj, mse, res) = _fetch_stop(its, traces, config)
    return w, u, obj.T, mse.T, res.T, iterations


def _solve_dense_path(problem: Problem, lams, config: SolverConfig, *,
                      w0, u0_b, w_true=None, clip_fn=None,
                      affine_fn=None) -> SolveResult:
    """A fixed-budget lambda path on the dense engine (the reference
    vmaps ``_solve_dense`` over the lambdas): every lane from the shared
    ``w0`` (V, n) and its own ``u0_b`` (L, E, n), one step of all lanes
    at a time; the kernel hooks take the lane axis in one launch."""
    _check_cadence(config)
    _storage_dtype(config, fused=False)
    lanes = _path_lanes(problem, lams, w_true)
    w0_b = torch.as_tensor(w0, dtype=torch.float32,
                           device=problem.device).expand(
        (len(lams),) + tuple(w0.shape)).clone()
    w, u, obj, mse, res = _batched_scan_impl(
        lanes, w0_b, u0_b, num_iters=config.num_iters, rho=config.rho,
        metric_every=config.metric_every, clip_fn=clip_fn,
        affine_fn=affine_fn, record_residual=config.record_residual)
    return _lane_result(problem, lams, config, w, u, obj.T, mse.T,
                        None if res is None else res.T, w_true)


@register_backend("pallas")
def solve_pallas(problem: Problem, config: SolverConfig, *, w0=None,
                 u0=None, w_true=None) -> SolveResult:
    """Kernel backend.

    Default on the card (opt-out via ``fused=False`` / ``REPRO_FUSED=0``):
    the *fused* primal-dual kernel — one pass per iteration over the
    edge-blocked graph layout (``kernels/pd_step.py``) — for every
    registered loss (squared, lasso, logistic) with ``tv``/``tv2``, in
    float32 or bfloat16 storage (on the CPU, its plain version).
    Otherwise the dense path with the unfused kernels wired in:
    the dual clip through ``kernels.ops.tv_prox`` (TV regularizer only)
    and the squared loss's affine prox through
    ``kernels.ops.batched_affine``; ``config.clip_fn``/``config.affine_fn``
    override either (and disable fusion).
    """
    if _should_fuse(problem, config):
        return _solve_fused(problem, config, w0=w0, u0=u0, w_true=w_true)
    clip_fn, affine_fn = resolve_kernel_hooks(problem, config, True)
    return _solve_dense(problem, config, w0=w0, u0=u0, w_true=w_true,
                        clip_fn=clip_fn, affine_fn=affine_fn)


# ---------------------------------------------------------------------------
# Federated backend (the message-passing runtime, repro_torch.federated)
# ---------------------------------------------------------------------------

@register_backend("federated")
def solve_federated(problem: Problem, config: SolverConfig, *, w0=None,
                    u0=None, w_true=None) -> SolveResult:
    """Run the federated message-passing runtime as a solver backend.

    ``config.federated`` (a ``repro_torch.federated.FederatedConfig``)
    carries the runtime policies — participation, local updates,
    compression, checkpointing; this solver config's ``num_iters`` (as
    rounds), ``rho``, ``metric_every``, ``tol``, and
    ``compute_diagnostics`` override the loop shape so backends stay
    comparable under one SolverConfig.  The default (``federated=None``)
    is synchronous full participation — the dense oracle mode the
    conformance suite locks down.
    """
    _storage_dtype(config, fused=False)
    # local import: repro_torch.federated layers on this module
    from repro_torch.federated import FederatedConfig, run_federated

    fed = (config.federated if config.federated is not None
           else FederatedConfig())
    if not isinstance(fed, FederatedConfig):
        raise TypeError("SolverConfig.federated must be a "
                        f"repro_torch.federated.FederatedConfig, got {fed!r}")
    fed = dataclasses.replace(
        fed, num_rounds=config.num_iters, rho=config.rho,
        metric_every=config.metric_every, tol=config.tol,
        compute_diagnostics=config.compute_diagnostics)
    return run_federated(problem, fed, w0=w0, u0=u0,
                         w_true=w_true).to_solve_result()


# ---------------------------------------------------------------------------
# Sharded backends (message passing over a mesh of ranks, core/distributed.py)
# ---------------------------------------------------------------------------

def _shard_layout(problem: Problem, config: SolverConfig):
    """(mesh, num_shards, shard) of a sharded solve: ``config.mesh`` or a
    one-rank mesh on the problem's device, the shard count (by default
    the mesh axis's size), and the shard this rank runs (its index along
    the axis)."""
    from repro_torch.core.mesh import make_host_mesh

    mesh = (config.mesh if config.mesh is not None
            else make_host_mesh(1, 1, device=problem.device))
    num_shards = (config.num_shards if config.num_shards is not None
                  else mesh.shape[config.mesh_axis])
    return mesh, num_shards, (mesh.rank if config.mesh_axis == "data"
                              else 0)


def _final_metrics(problem: Problem, w, w_true):
    """Objective and MSE at the final iterate only (traces of length 1)."""
    obj = problem.objective(w)[None]
    if w_true is None:
        return obj, None
    return obj, graph_signal_mse(w, w_true,
                                 1.0 - problem.data.labeled_mask)[None]


@register_backend("sharded")
def solve_sharded(problem: Problem, config: SolverConfig, *, w0=None,
                  u0=None, w_true=None) -> SolveResult:
    """Partition the graph over ``config.mesh`` and run the halo-exchange
    solver, one shard a rank.  Objective/MSE are evaluated once at the
    final iterate (the sharded loop carries prox parameters, not raw
    node data), so the traces have length 1.
    """
    _storage_dtype(config, fused=False)
    # local import: core.distributed delegates its shim back here
    from repro_torch.core.distributed import (halo_exchange_bytes_per_iter,
                                              resolve_comm, shard_problem,
                                              solve_nlasso_sharded)
    from repro_torch.core.partition import (permute_edge_array_device,
                                            permute_node_array_device,
                                            unpermute_edge_array_device,
                                            unpermute_node_array_device)

    if not problem.regularizer.fusable:
        raise NotImplementedError(
            "sharded backend needs an edge-elementwise (fusable) "
            "regularizer resolvent")
    mesh, num_shards, shard = _shard_layout(problem, config)
    with obs.span("sharded_plan", backend="sharded"):
        sp = shard_problem(problem.graph, problem.data, num_shards,
                           partitioner=config.partitioner,
                           loss=problem.loss, shard=shard)
    comm = resolve_comm(
        config.comm,
        sp.plan.cut_edges / max(problem.graph.num_edges, 1))
    # device-side layout permutes: warm-started continuation keeps the
    # carry on the device
    if w0 is not None:
        w0 = permute_node_array_device(sp.plan, torch.as_tensor(
            w0, dtype=torch.float32, device=problem.device))
    if u0 is not None:
        u0 = permute_edge_array_device(sp.plan, torch.as_tensor(
            u0, dtype=torch.float32, device=problem.device))
    w_pad, u_pad, iterations = solve_nlasso_sharded(
        sp, mesh, float(problem.lam), config.num_iters,
        axis=config.mesh_axis, rho=config.rho, comm=comm, w0=w0, u0=u0,
        return_u=True, tol=config.tol, tol_every=config.metric_every,
        reg=problem.regularizer)
    w = unpermute_node_array_device(sp.plan, w_pad, problem.num_nodes)
    u = unpermute_edge_array_device(sp.plan, u_pad,
                                    problem.graph.num_edges)
    obj, mse = _final_metrics(problem, w, w_true)
    diag = _with_iterations(_diagnostics(problem, w, u, config), config,
                            iterations)
    diag = _with_halo_traffic(
        diag, halo_exchange_bytes_per_iter(sp, comm, problem.num_features),
        iterations, comm, "sharded")
    return SolveResult(w=w, u=u, objective=obj, mse=mse, lam=problem.lam,
                       diagnostics=diag)


def _with_halo_traffic(diag, bytes_per_iter: int, iterations: int,
                       comm: str, backend: str):
    """Surface inter-shard exchange volume per solve (and mirror it onto
    the obs registry, CommLedger.export_obs-style)."""
    total = int(bytes_per_iter) * int(iterations)
    diag = dict(diag or {})
    diag["halo_exchange_bytes_per_iter"] = float(bytes_per_iter)
    diag["halo_exchange_bytes"] = float(total)
    if obs.enabled():
        obs.counter(
            "halo_exchange_bytes_total",
            help="inter-shard dual/primal halo exchange payload bytes",
            comm=comm, backend=backend).inc(total)
        obs.counter(
            "halo_exchange_iterations_total",
            help="iterations contributing halo exchanges",
            comm=comm, backend=backend).inc(int(iterations))
    return diag


@register_backend("sharded_fused")
def solve_sharded_fused(problem: Problem, config: SolverConfig, *, w0=None,
                        u0=None, w_true=None) -> SolveResult:
    """Two-level scale-out: hierarchical partition (cluster cuts between
    shards, RCM + edge blocks within), each rank stepping the fused
    edge-blocked kernel on its shard's layout with a per-iteration dual
    halo refresh between shards.  On the card the kernel runs every
    step, and a loss it cannot take is refused (never the plain step
    there).  ``comm="auto"`` (the default) picks the boundary exchange
    when the inter-shard cut fraction is < 25%.  Objective/MSE are
    evaluated once at the final iterate, like ``sharded``.
    """
    _storage_dtype(config, fused=False)
    from repro_torch.core.distributed import (halo_exchange_bytes_per_iter,
                                              shard_problem_fused,
                                              solve_nlasso_hier)

    if not problem.regularizer.fusable:
        raise NotImplementedError(
            "sharded_fused needs an edge-elementwise (fusable) "
            "regularizer resolvent")
    num_samples = problem.data.x.shape[-2]
    if problem.device.type == "cuda" and not (
            problem.loss.kernel_safe and pd_kernel.kernel_takes(
                problem.loss, problem.num_features, num_samples)):
        raise NotImplementedError(
            f"loss {type(problem.loss).__name__} at n = "
            f"{problem.num_features} cannot run inside the fused_pd_step "
            "kernel; run sharded_fused on the CPU or use sharded")
    if config.clip_fn is not None or config.affine_fn is not None:
        raise NotImplementedError(
            "custom kernel hooks target the unfused engine")

    mesh, num_shards, shard = _shard_layout(problem, config)
    try:
        param_floats = problem.loss.prox_param_floats(
            num_samples, problem.num_features)
    except NotImplementedError:
        param_floats = 0
    hint = (problem.num_features, param_floats, 4, _fused_window_cap())
    with obs.span("sharded_plan", backend="sharded_fused"):
        sp = shard_problem_fused(problem.graph, problem.data, num_shards,
                                 partitioner=config.partitioner,
                                 loss=problem.loss, window_hint=hint,
                                 shard=shard)
    w, u, iterations, comm = solve_nlasso_hier(
        sp, mesh, float(problem.lam), config.num_iters,
        axis=config.mesh_axis, rho=config.rho, comm=config.comm, w0=w0,
        u0=u0, tol=config.tol, tol_every=config.metric_every,
        reg=problem.regularizer)
    obj, mse = _final_metrics(problem, w, w_true)
    diag = _with_iterations(_diagnostics(problem, w, u, config), config,
                            iterations)
    diag = _with_halo_traffic(
        diag, halo_exchange_bytes_per_iter(sp, comm, problem.num_features),
        iterations, comm, "sharded_fused")
    return SolveResult(w=w, u=u, objective=obj, mse=mse, lam=problem.lam,
                       diagnostics=diag)

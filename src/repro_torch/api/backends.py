"""Execution backends for the port's solver — thin drivers over the engine.

Two registered backends run the canonical primal-dual iteration
(:func:`repro_torch.engine.step.pd_step`, paper eqs. 14-15) and return
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

The reference's ``sharded``, ``sharded_fused`` and ``federated``
backends, ``tol`` early stopping and ``dtype="bfloat16"`` storage are not
in the port yet: each raises ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings it.
"""
from __future__ import annotations

import os
import weakref
from typing import Callable

import torch

from repro_torch.api.losses import Loss, SquaredLoss
from repro_torch.api.problem import Problem, SolveResult, SolverConfig
from repro_torch.api.regularizers import TotalVariation
from repro_torch.core.graph import graph_signal_mse, plan_edge_blocks
from repro_torch.core.losses import NodeData
from repro_torch.core.partition import gather_padded
from repro_torch.engine import (DenseExecutor, certificate, pd_residual,
                                scan_solve)
from repro_torch.engine import pd_step as engine_pd_step
from repro_torch.kernels import ops

BACKENDS: dict[str, Callable] = {}

# registered in the reference, not yet in the port: name -> ROADMAP item
_PENDING_BACKENDS = {
    "sharded": "ROADMAP.md Open items §1 item 9",
    "sharded_fused": "ROADMAP.md Open items §1 item 10",
    "federated": "ROADMAP.md Open items §1 item 11",
}


def register_backend(name: str):
    """Decorator adding ``fn(problem, config, *, w0, u0, w_true)``."""
    def deco(fn):
        BACKENDS[name] = fn
        return fn
    return deco


def get_backend(name: str) -> Callable:
    if name in _PENDING_BACKENDS:
        raise NotImplementedError(
            f"backend {name!r} is not ported yet: {_PENDING_BACKENDS[name]}")
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


def _check_config(config: SolverConfig) -> None:
    """Cadence, plus the loud refusal of what this slice does not run."""
    if config.num_iters % config.metric_every:
        raise ValueError(
            f"metric_every={config.metric_every} must divide "
            f"num_iters={config.num_iters}")
    if config.tol is not None:
        raise NotImplementedError(
            "SolverConfig.tol (the device-resident stopping loop and its "
            "one-transfer contract) is not ported yet: ROADMAP.md Open "
            "items §1 item 6")
    if config.dtype == "bfloat16":
        raise NotImplementedError(
            "SolverConfig.dtype='bfloat16' storage is not ported yet: "
            "ROADMAP.md Open items §1 item 6")
    if config.dtype != "float32":
        raise ValueError(
            f"unsupported SolverConfig.dtype {config.dtype!r}; use "
            "'float32' or 'bfloat16'")


def _initial_state(problem: Problem, w0, u0):
    """(w0, u0) as f32 tensors on the problem's device (zeros if None)."""
    V, n, dev = problem.num_nodes, problem.num_features, problem.device
    w0 = (torch.zeros((V, n), dtype=torch.float32, device=dev) if w0 is None
          else torch.as_tensor(w0, dtype=torch.float32, device=dev))
    u0 = (torch.zeros((problem.graph.num_edges, n), dtype=torch.float32,
                      device=dev) if u0 is None
          else torch.as_tensor(u0, dtype=torch.float32, device=dev))
    return w0, u0


# ---------------------------------------------------------------------------
# Dense backend (Python loop over the dense executor)
# ---------------------------------------------------------------------------

def make_metrics_fn(loss: Loss, reg, graph, data, lam, w_true):
    """``metrics(w) -> (objective, mse)`` — the one trace formula.

    MSE is the paper's eq. (24) over the unlabeled (test) nodes, 0 when
    no ground truth is supplied.
    """
    unlabeled = 1.0 - data.labeled_mask

    def metrics(w):
        obj = loss.empirical_error(data, w) + reg.value(graph, w, lam)
        if w_true is None:
            mse = torch.zeros((), dtype=torch.float32, device=w.device)
        else:
            mse = graph_signal_mse(w, w_true, unlabeled)
        return obj, mse

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


def _solve_dense(problem: Problem, config: SolverConfig, *, w0=None, u0=None,
                 w_true=None, clip_fn=None, affine_fn=None) -> SolveResult:
    _check_config(config)
    w0, u0 = _initial_state(problem, w0, u0)
    w, u, obj, mse, res = _dense_scan_impl(
        problem, w0, u0, w_true, num_iters=config.num_iters,
        rho=config.rho, metric_every=config.metric_every, clip_fn=clip_fn,
        affine_fn=affine_fn, record_residual=config.record_residual)
    return SolveResult(w=w, u=u, objective=obj,
                       mse=None if w_true is None else mse,
                       lam=problem.lam,
                       diagnostics=_diagnostics(problem, w, u, config),
                       residual=res)


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
    inside the kernel (``kernel_safe``: lasso and logistic do not yet, so
    they run the unfused path there, as a loss with ``kernel_safe=False``
    does on the reference's TPU).  Custom kernel hooks disable fusion
    (they target the unfused engine)."""
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


def _fused_window_fits(problem: Problem) -> bool:
    """Plan (or fetch) the graph's layout and check the window cap."""
    try:
        param_floats = problem.loss.prox_param_floats(
            problem.data.x.shape[1], problem.num_features)
    except NotImplementedError:
        return False
    cap = _fused_window_cap()
    lt = _graph_layout(problem.graph, window_hint=(
        problem.num_features, param_floats, 4, cap))
    return lt.window_bytes(problem.num_features,
                           param_floats=param_floats) <= cap


def _should_fuse(problem: Problem, config: SolverConfig) -> bool:
    """The one fused-dispatch gate."""
    return (_fused_enabled(problem, config)
            and _fused_supported(problem, config)
            and _fused_window_fits(problem))


def _fused_setup(graph, data, lam, w_true, *, loss, reg, layout):
    """Per-solve prep for the fused engine: layout padding, stepsizes,
    windowed prox parameters, and the metric fn (original node order,
    the dense engine's formulas)."""
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
    params_s = tuple(lt.pad_node_store(params[k]).contiguous()
                     for k in pkeys)
    tau_s = lt.pad_node_store(tau_l[:, None])
    src2, dst2 = lt.src[:, None], lt.dst[:, None]
    sig2 = sig_l[:, None]
    la2 = (lam * lt.weights)[:, None]
    metrics_fn = make_metrics_fn(loss, reg, graph, data, lam, w_true)
    node_inv = lt.node_inv.long()

    def metrics(w_l):
        return metrics_fn(w_l[node_inv])

    return (params_s, pkeys, tau_l, tau_s, sig_l, sig2, src2, dst2, la2,
            metrics)


def _fused_run_iters(lt, inc_e, inc_s, params_s, pkeys, tau_s, src2, dst2,
                     sig2, la2, *, loss, reg, rho):
    """Build ``run_iters(state, iters)`` advancing the padded stores.

    The stores are the solve's own tensors: each call's fresh owned
    outputs are written back into them in place (the halo padding rows
    are never written), as the reference does with a
    ``dynamic_update_slice``.
    """
    bv, eb = lt.block_nodes, lt.block_edges
    kn, klo, khi = lt.kn, lt.klo, lt.khi

    def run_iters(state, iters):
        w_store, u_store = state
        w_new, u_new = ops.pd_step(
            w_store, u_store, inc_e, inc_s, params_s, tau_s, src2, dst2,
            sig2, la2, loss=loss, reg=reg, pkeys=pkeys, block_nodes=bv,
            block_edges=eb, kn=kn, klo=klo, khi=khi, rho=rho, iters=iters)
        w_store[:w_new.shape[0]].copy_(w_new)
        u_store[klo * eb:klo * eb + u_new.shape[0]].copy_(u_new)
        return state

    return run_iters


def _fused_scan_impl(problem: Problem, w0_l, u0_l, w_true, *, layout,
                     num_iters: int, rho: float, metric_every: int,
                     record_residual: bool = False):
    """The fused engine: loop the fused PD step over the edge-blocked
    layout, recording metrics on the cadence.  A single-block layout
    runs each metric block as one launch (``iters=metric_every``).
    Returns owned-layout ``(w_l, u_l, obj, mse, res)``."""
    lt = layout
    (params_s, pkeys, tau_l, tau_s, sig_l, sig2, src2, dst2, la2,
     metrics) = _fused_setup(problem.graph, problem.data, problem.lam,
                             w_true, loss=problem.loss,
                             reg=problem.regularizer, layout=lt)

    run_iters = _fused_run_iters(
        lt, lt.pad_node_store(lt.inc_edges), lt.pad_node_store(lt.inc_signs),
        params_s, pkeys, tau_s, src2, dst2, sig2, la2, loss=problem.loss,
        reg=problem.regularizer, rho=rho)

    eb, klo, khi = lt.block_edges, lt.klo, lt.khi

    def owned(state):
        w_store, u_store = state
        return (w_store[:lt.nodes_pad],
                u_store[klo * eb:klo * eb + lt.edges_pad])

    run_block, residual_fn = run_iters, None
    if record_residual:
        # the residual reads both ends of a block's closing step, so the
        # in-place step works on a copy of the state it is given
        def run_block(state, iters):
            return run_iters(tuple(t.clone() for t in state), iters)

        def residual_fn(prev, new):
            w_p, u_p = owned(prev)
            w_n, u_n = owned(new)
            return pd_residual(tau_l, sig_l, w_p, u_p, w_n, u_n)

    n = w0_l.shape[1]
    zeros = u0_l.new_zeros
    w_store0 = lt.pad_node_store(w0_l)
    u_store0 = torch.cat([zeros((klo * eb, n)), u0_l, zeros((khi * eb, n))])
    state, traces = scan_solve(
        run_block, lambda s: metrics(s[0][:lt.nodes_pad]),
        (w_store0, u_store0), num_iters=num_iters,
        metric_every=metric_every, multi_iter_block=(lt.num_blocks == 1),
        residual_fn=residual_fn)
    if record_residual:
        (obj_trace, mse_trace), res_trace = traces
    else:
        (obj_trace, mse_trace), res_trace = traces, None
    w_l, u_l = owned(state)
    return w_l, u_l, obj_trace, mse_trace, res_trace


def _solve_fused(problem: Problem, config: SolverConfig, *, w0=None,
                 u0=None, w_true=None) -> SolveResult:
    """Solve via the fused PD kernel on the edge-blocked graph layout."""
    _check_config(config)
    lt = _graph_layout(problem.graph)
    n, dev = problem.num_features, problem.device

    w0_l = torch.zeros((lt.nodes_pad, n), dtype=torch.float32, device=dev)
    if w0 is not None:
        w0_l = gather_padded(torch.as_tensor(w0, dtype=torch.float32,
                                             device=dev), lt.node_perm)
    u0_l = torch.zeros((lt.edges_pad, n), dtype=torch.float32, device=dev)
    edge_pos = lt.edge_pos.long()
    if u0 is not None:
        u0_l[edge_pos] = (torch.as_tensor(u0, dtype=torch.float32,
                                          device=dev)
                          * lt.edge_flip[:, None])

    w_l, u_l, obj, mse, res = _fused_scan_impl(
        problem, w0_l, u0_l, w_true, layout=lt,
        num_iters=config.num_iters, rho=config.rho,
        metric_every=config.metric_every,
        record_residual=config.record_residual)
    w = w_l[lt.node_inv.long()]
    u = u_l[edge_pos] * lt.edge_flip[:, None]
    return SolveResult(w=w, u=u, objective=obj,
                       mse=None if w_true is None else mse,
                       lam=problem.lam,
                       diagnostics=_diagnostics(problem, w, u, config),
                       residual=res)


@register_backend("pallas")
def solve_pallas(problem: Problem, config: SolverConfig, *, w0=None,
                 u0=None, w_true=None) -> SolveResult:
    """Kernel backend.

    Default on the card (opt-out via ``fused=False`` / ``REPRO_FUSED=0``):
    the *fused* primal-dual kernel — one pass per iteration over the
    edge-blocked graph layout (``kernels/pd_step.py``) — for the squared
    loss with ``tv``/``tv2`` (on the CPU, its plain version runs every
    loss).  Otherwise the dense path with the unfused kernels wired in:
    the dual clip through ``kernels.ops.tv_prox`` (TV regularizer only)
    and the squared loss's affine prox through
    ``kernels.ops.batched_affine``; ``config.clip_fn``/``config.affine_fn``
    override either (and disable fusion).
    """
    _check_config(config)
    if _should_fuse(problem, config):
        return _solve_fused(problem, config, w0=w0, u0=u0, w_true=w_true)
    clip_fn, affine_fn = resolve_kernel_hooks(problem, config, True)
    return _solve_dense(problem, config, w0=w0, u0=u0, w_true=w_true,
                        clip_fn=clip_fn, affine_fn=affine_fn)

"""The Solver front-end: backend dispatch, continuation, lambda paths and
batched solves.

    problem = Problem.create(graph, data, lam=1e-3, loss="squared")
    result = Solver(SolverConfig(num_iters=1000, rho=1.9)).run(problem)

``Solver.run`` dispatches through the backend registry and optionally
wraps the run in the lambda-continuation schedule.  ``solve_path`` runs
one problem along a whole lambda path and ``solve_many`` a batch of
shape-matched problems, each as one solve over a leading lane axis
(the reference ``jax.vmap``-s its engines; the port writes the axis out,
and every kernel takes it in one launch).  ``REPRO_SOLVER_MAX_ITERS``
(env) caps every phase's iteration count.

Where the reference's device control flow has no PyTorch counterpart,
the port follows ``engine/loop.py:device_loop``:

  * the masked sweep's ``lax.while_loop`` is ``device_loop`` on an
    "every lane done" device flag (a CUDA graph with a conditional node
    on the card): each block selects the old state of the done lanes
    with ``torch.where`` (so a frozen lane stays bit-identical), and no
    block runs after the last lane's stop; one device->host fetch reads
    the block count and the per-lane iterations;
  * the cascade's ``lax.cond`` computes every lambda's block and selects
    on ``residual > trigger``, so it computes blocks the reference
    skips, without a host sync per lambda.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api import backends
from repro_torch.api.backends import (_batched_certificate, _Lanes,
                                      _lane_block_fn, _path_lanes,
                                      get_backend, lane_values,
                                      resolve_kernel_hooks,
                                      solve_dense_batched)
from repro_torch.api.problem import Problem, SolveResult, SolverConfig
from repro_torch.engine import capped as _capped
from repro_torch.engine import certificate
from repro_torch.engine import default_warm_lam as _default_warm_lam
from repro_torch.engine import device_fetch, device_loop


@dataclasses.dataclass(frozen=True)
class Solver:
    """Backend-dispatching runner for :class:`Problem` instances."""

    config: SolverConfig = SolverConfig()

    def run(self, problem: Problem, *, w0=None, u0=None,
            w_true=None) -> SolveResult:
        """Solve ``problem`` per the config on the problem's device.

        With telemetry on, counts ``repro_solves_total{backend}`` and
        times the ``solver_run`` span (host wall time: on the card it
        ends once the solve is enqueued, see ``obs.span``)."""
        cfg = self.config
        backend = get_backend(cfg.backend)
        if w_true is not None:
            w_true = w_true.to(problem.device)
        if obs.enabled():
            obs.counter("repro_solves_total",
                        help="solver runs by backend",
                        backend=cfg.backend).inc()
        with obs.span("solver_run", backend=cfg.backend):
            if not cfg.continuation:
                run_cfg = cfg.replace(
                    num_iters=_capped(cfg.num_iters, cfg.metric_every))
                return backend(problem, run_cfg, w0=w0, u0=u0,
                               w_true=w_true)

            warm_lam = (cfg.warm_lam if cfg.warm_lam is not None
                        else _default_warm_lam(float(problem.lam)))
            warm_cfg = cfg.replace(
                continuation=False, compute_diagnostics=False,
                record_residual=False,
                num_iters=_capped(cfg.warm_iters, cfg.metric_every))
            warm = backend(problem.with_lam(warm_lam), warm_cfg, w0=w0,
                           u0=u0)
            # re-project the warm duals onto the target feasible set
            u_warm = problem.regularizer.project_dual(
                warm.u, problem.graph, problem.lam)
            final_cfg = cfg.replace(
                continuation=False,
                num_iters=_capped(cfg.final_iters, cfg.metric_every))
            return backend(problem, final_cfg, w0=warm.w, u0=u_warm,
                           w_true=w_true)


# ---------------------------------------------------------------------------
# Masked tol sweep: every lambda stops on its own residual
# ---------------------------------------------------------------------------

def _path_lane_fns(problem: Problem, lams, w_true, params, *, rho: float,
                   metric_every: int, clip_fn, affine_fn):
    """Lane machinery of a lambda path (``lams`` host floats):
    ``advance(state) -> (state, residual (L,))`` runs one metric block of
    every lane at its own lambda, the residual its block-max eq.-11
    residual; ``lane_metrics(w_b)`` evaluates the dense engine's trace
    formulas of every lane at its lambda at once
    (``backends.lane_metrics``)."""
    lanes: _Lanes = _path_lanes(problem, lams, w_true, params)
    advance = _lane_block_fn(lanes, rho=rho, metric_every=metric_every,
                             clip_fn=clip_fn, affine_fn=affine_fn)
    return advance, lanes.metrics


def _cascade_impl(problem: Problem, lams_desc, w_warm, u_warm, params,
                  trigger: float, *, rho: float, metric_every: int,
                  clip_fn, affine_fn):
    """Residual-triggered neighbour continuation cascade.

    Walks the lambda path in *descending* order carrying one state: at
    each lambda the carried duals are re-projected onto that lambda's
    feasible set and, while the carried residual is above ``trigger``,
    one metric block runs before the state is that lambda's warm start;
    each lambda starts from its larger neighbour's iterate (nLasso
    continuation, cf. 1903.11178).  The reference skips the block with
    ``lax.cond`` once the carry is converged; here every lambda's block
    is computed and the select on ``residual > trigger`` keeps or drops
    it, so the test never leaves the device.  Returns per-lambda ``(w,
    u)`` inits stacked in path order (descending).
    """
    reg, graph = problem.regularizer, problem.graph
    w, u = w_warm[None], u_warm[None]
    res = torch.full((1,), float("inf"), dtype=torch.float32,
                     device=problem.device)
    ws, us = [], []
    for lam in lams_desc:
        lam_col = lane_values([lam], problem.device)[:, None]
        u = reg.project_dual(u, graph, lam_col)
        advance, _ = _path_lane_fns(
            problem, [lam], None, params, rho=rho,
            metric_every=metric_every, clip_fn=clip_fn, affine_fn=affine_fn)
        (w_n, u_n), res_n = advance((w, u))
        go = res > trigger
        w = torch.where(go[:, None, None], w_n, w)
        u = torch.where(go[:, None, None], u_n, u)
        res = torch.where(go, res_n, res)
        ws.append(w[0])
        us.append(u[0])
    return torch.stack(ws), torch.stack(us)


def _masked_sweep_impl(problem: Problem, lams, w0_b, u0_b, w_true, params,
                       tol: float, *, num_iters: int, rho: float,
                       metric_every: int, clip_fn, affine_fn):
    """The masked tol sweep: every lambda lane advances one metric block
    at a time with a per-lane ``done`` mask.

    Converged lanes are *frozen*: the post-block select on the mask keeps
    their state fixed, so each lane's iterate stream is the stream a
    single tol solve from the same init produces, and its stopping
    iteration (the first block whose block-max residual is <= tol) is
    the single solve's.  The reference's while loop exits when every
    lane is done or the budget is spent; here the blocks run under
    ``engine.loop.device_loop`` on the flag "some lane runs", which
    counts the blocks run on the device and runs none after the last
    stop.  Frozen lanes record residual 0 and
    their frozen metrics.

    Returns ``(w_b, u_b, (obj, mse, res) trace buffers (num_blocks, L),
    per-lane iterations (L,) int32, blocks run)``, the last two on the
    device: one fetch reads both.
    """
    advance, lane_metrics = _path_lane_fns(
        problem, lams, w_true, params, rho=rho, metric_every=metric_every,
        clip_fn=clip_fn, affine_fn=affine_fn)
    dev = problem.device
    done = torch.zeros((len(lams),), dtype=torch.bool, device=dev)
    iters = torch.zeros((len(lams),), dtype=torch.int32, device=dev)

    def run_block(state, active):
        del active           # done lanes freeze; so, once all are, does all
        w, u, done, iters = state
        new, res = advance((w, u))
        # converged lanes are frozen: select the old state on the mask
        frozen = done[:, None, None]
        w = torch.where(frozen, w, new[0])
        u = torch.where(frozen, u, new[1])
        iters = iters + torch.where(done, 0, metric_every).to(torch.int32)
        res = torch.where(done, torch.zeros_like(res), res)
        done = done | (res <= tol)
        # the loop's stopping residual: above any tol while a lane runs
        go = torch.where(torch.all(done), -torch.inf, torch.inf)
        return (w, u, done, iters), (*lane_metrics(w), res), go

    (w_b, u_b, _, iters), traces, its = device_loop(
        run_block, (w0_b, u0_b, done, iters), num_iters=num_iters,
        metric_every=metric_every, tol=tol)
    return w_b, u_b, traces, iters, its // metric_every


#: cascade trigger: a lambda inherits its neighbour's state untouched
#: when that carry is already within TRIGGER_SCALE * tol
_CASCADE_TRIGGER_SCALE = 10.0


def _masked_starts(problem: Problem, lams: np.ndarray, cfg: SolverConfig,
                   warm: SolveResult) -> tuple:
    """The masked sweep's set-up: the kernel hooks and prox parameters,
    and every lane's start from the neighbour cascade off the shared warm
    solve.  Returns ``(w0_b, u0_b, params, run)``, ``run`` the sweep's
    keyword arguments."""
    clip_fn, affine_fn = resolve_kernel_hooks(problem, cfg,
                                              cfg.backend == "pallas")
    params = problem.loss.prox_setup(problem.data,
                                     problem.graph.primal_stepsizes())
    order = np.argsort(-lams, kind="stable")   # descending: large first
    inv_order = np.argsort(order, kind="stable")
    reg, dev = problem.regularizer, problem.device
    u_warm = reg.project_dual(warm.u, problem.graph, float(np.max(lams)))
    run = dict(rho=cfg.rho, metric_every=cfg.metric_every, clip_fn=clip_fn,
               affine_fn=affine_fn)
    w_desc, u_desc = _cascade_impl(
        problem, lams[order], warm.w, u_warm, params,
        _CASCADE_TRIGGER_SCALE * cfg.tol, **run)
    # back to path order (host indices: no index tensor to copy over)
    w0_b = torch.stack([w_desc[i] for i in inv_order])
    u0_b = reg.project_dual(torch.stack([u_desc[i] for i in inv_order]),
                            problem.graph, lane_values(lams, dev)[:, None])
    return w0_b, u0_b, params, run


def _solve_path_masked(problem: Problem, lams: np.ndarray,
                       cfg: SolverConfig, warm: SolveResult, *,
                       w_true=None) -> SolveResult:
    """tol-mode ``solve_path``: neighbour cascade + masked sweep, with
    one device->host fetch."""
    w0_b, u0_b, params, run = _masked_starts(problem, lams, cfg, warm)
    budget = _capped(cfg.final_iters, cfg.metric_every)
    w_b, u_b, (obj, mse, res), iters_b, k = _masked_sweep_impl(
        problem, lams, w0_b, u0_b, w_true, params, cfg.tol,
        num_iters=budget, **run)
    # one fetch for the sweep's host-side facts: the block count and the
    # per-lambda stopping iterations
    host = device_fetch(torch.cat([k.reshape(1), iters_b]))
    blocks, iters_np = int(host[0]), np.asarray(host[1:])
    obj, mse, res = (t[:blocks].T for t in (obj, mse, res))

    diag = {}
    if cfg.compute_diagnostics:
        diag = _batched_certificate(
            [problem.with_lam(float(v)) for v in lams], w_b, u_b)
    diag["iterations"] = iters_np
    return SolveResult(w=w_b, u=u_b, objective=obj,
                       mse=None if w_true is None else mse,
                       lam=torch.from_numpy(lams.copy()), diagnostics=diag,
                       residual=res)


def solve_path(problem: Problem, lams, config: SolverConfig | None = None,
               *, w_true=None) -> SolveResult:
    """Solve one problem along a whole lambda path (hyperparameter sweep).

    One coarse solve at the continuation warm strength is shared by every
    path point; the per-lambda final solves then run together, one lane
    per lambda (the fused kernel, ``tv_prox`` and ``batched_affine`` each
    launch once for all lanes).  Returns a SolveResult whose leaves carry
    a leading ``len(lams)`` axis (``result.lam`` recovers the path).
    Dense/pallas backends only; the fused lanes when ``_should_fuse``
    says so, as ``Solver.run`` routes one problem.

    With ``config.tol`` set, the sweep is *masked*: a residual-triggered
    continuation cascade warm-starts every lambda from its larger
    neighbour, then every lambda lane advances with a per-lane ``done``
    mask — each lane freezes once its own eq.-11 residual certifies
    (``diagnostics["iterations"]`` reports the per-lambda stopping
    iterations; ``final_iters`` is the per-lambda budget).  It runs the
    dense engine (with the unfused kernels on ``backend="pallas"``), as
    the reference does.
    """
    cfg = config if config is not None else SolverConfig(rho=1.9)
    if cfg.backend not in ("dense", "pallas"):
        raise NotImplementedError(
            "solve_path runs the dense or fused engine over lanes; backend "
            f"must be 'dense' or 'pallas', got {cfg.backend!r}")
    lams = np.asarray(lams, np.float32)
    if lams.ndim != 1 or lams.shape[0] == 0:
        raise ValueError("lams must be a non-empty 1-D array")
    if w_true is not None:
        w_true = w_true.to(problem.device)

    warm_lam = (cfg.warm_lam if cfg.warm_lam is not None
                else _default_warm_lam(float(np.max(lams))))
    warm_cfg = cfg.replace(
        continuation=False, compute_diagnostics=False,
        record_residual=False,
        num_iters=_capped(cfg.warm_iters, cfg.metric_every))
    warm = get_backend(cfg.backend)(problem.with_lam(warm_lam), warm_cfg)

    if cfg.tol is not None:
        # masked tol sweep on the dense engine: every lambda stops on
        # its own residual
        return _solve_path_masked(problem, lams, cfg, warm, w_true=w_true)

    final_cfg = cfg.replace(
        continuation=False,
        num_iters=_capped(cfg.final_iters, cfg.metric_every))
    lam_col = lane_values(lams, problem.device)[:, None]
    u0_b = problem.regularizer.project_dual(
        warm.u.expand((len(lams),) + tuple(warm.u.shape)), problem.graph,
        lam_col)
    if cfg.backend == "pallas" and backends._should_fuse(
            problem, cfg, lanes=len(lams)):
        # the fused kernel over every lambda lane at once
        return backends._solve_fused(problem, final_cfg, w0=warm.w,
                                     u0=u0_b, w_true=w_true, lams=lams)
    clip_fn, affine_fn = resolve_kernel_hooks(problem, cfg,
                                              cfg.backend == "pallas")
    return backends._solve_dense_path(
        problem, lams, final_cfg, w0=warm.w, u0_b=u0_b, w_true=w_true,
        clip_fn=clip_fn, affine_fn=affine_fn)


def _batch_signature(problem: Problem) -> tuple:
    """Everything two problems must share to run as lanes of one solve:
    the template slots, the device and every array shape."""
    g, d = problem.graph, problem.data
    return (repr(problem.loss), repr(problem.regularizer),
            str(problem.device), g.num_nodes, g.num_edges, g.max_degree,
            tuple(d.x.shape), tuple(d.y.shape), tuple(d.sample_mask.shape),
            tuple(d.labeled_mask.shape))


def solve_many(problems, config: SolverConfig | None = None, *,
               w0s=None, u0s=None) -> list[SolveResult]:
    """Solve many shape-matched problems as ONE lane-stacked solve.

    Problems whose loss/regularizer templates and array shapes match
    stack along a leading lane axis — graph structure arrays included, so
    *different* structures of one shape batch together — and step as one
    dense engine (with the unfused kernels on ``backend="pallas"``, each
    taking the lane axis in one launch; ``batched_affine`` with one P per
    problem).  ``w0s``/``u0s`` are optional per-problem warm starts
    (None entries start from zeros).

    With ``config.tol`` set, early stopping is batch-granular: the solve
    stops once *every* problem's residual certifies (max over the batch),
    so all problems report the shared iteration count and each
    per-problem certificate remains individually valid.

    Returns one :class:`SolveResult` per problem, in order.
    """
    cfg = config if config is not None else SolverConfig(rho=1.9)
    problems = list(problems)
    if not problems:
        return []
    if cfg.backend not in ("dense", "pallas"):
        raise NotImplementedError(
            "solve_many runs the dense engine over lanes; backend must be "
            f"'dense' or 'pallas', got {cfg.backend!r}")
    if cfg.continuation:
        raise NotImplementedError(
            "solve_many runs single-phase solves; disable continuation "
            "and warm-start via w0s/u0s instead")
    ref_sig = _batch_signature(problems[0])
    for i, p in enumerate(problems[1:], start=1):
        sig = _batch_signature(p)
        if sig != ref_sig:
            raise ValueError(
                f"problems[{i}] does not shape-match problems[0]: "
                f"{sig} vs {ref_sig}; batch only shape-matched problems")

    p0 = problems[0]
    V, n, E, dev = p0.num_nodes, p0.num_features, p0.graph.num_edges, \
        p0.device

    def stack_inits(inits, rows):
        if inits is None:
            inits = [None] * len(problems)
        return torch.stack([
            torch.zeros((rows, n), dtype=torch.float32, device=dev)
            if x0 is None else torch.as_tensor(x0, dtype=torch.float32,
                                               device=dev) for x0 in inits])

    w0_b, u0_b = stack_inits(w0s, V), stack_inits(u0s, E)
    run_cfg = cfg.replace(num_iters=_capped(cfg.num_iters,
                                            cfg.metric_every))
    clip_fn, affine_fn = resolve_kernel_hooks(p0, run_cfg,
                                              run_cfg.backend == "pallas")
    w, u, obj, mse, res, iterations = solve_dense_batched(
        problems, run_cfg, w0_b, u0_b, clip_fn=clip_fn,
        affine_fn=affine_fn)

    diag_b = {}
    if cfg.compute_diagnostics:
        diag_b = _batched_certificate(problems, w, u)
    results = []
    for i, p in enumerate(problems):
        diag = {k: v[i] for k, v in diag_b.items()}
        if cfg.tol is not None:
            diag["iterations"] = int(iterations)
        results.append(SolveResult(
            w=w[i], u=u[i], objective=obj[i], mse=None, lam=p.lam,
            diagnostics=diag, residual=None if res is None else res[i]))
    return results


def solve(problem: Problem, config: SolverConfig | None = None,
          **run_kwargs) -> SolveResult:
    """Functional convenience: ``Solver(config).run(problem, ...)``."""
    return Solver(config if config is not None else SolverConfig()).run(
        problem, **run_kwargs)


__all__ = ["Solver", "solve", "solve_many", "solve_path", "certificate"]

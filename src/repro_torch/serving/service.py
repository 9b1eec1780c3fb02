"""SolveService: streaming, multi-tenant, warm-started GTVMin serving.

The port's ``repro.serving.service``: a service that holds many live
:class:`~repro_torch.api.problem.Problem` instances as *sessions* and
answers solve requests against them, reusing plans (RCM orders,
edge-blocked layouts) across tenants via the
:class:`~repro_torch.serving.cache.PlanCache` and warm-starting every
re-solve from the session's cached primal/dual state.  The sessions'
tensors live on their problems' device (the card unless the caller made
the problem on the CPU); a ``tol`` solve stops computing at its stop
(``engine.loop.device_loop``), so a warm answer costs the iterations it
needs, not the budget.

Request surface (all host-side, synchronous):

  * ``create_session(tenant, problem)``   — admit a problem.
  * ``update_session(id, delta, patch)``  — apply per-node data deltas
    (:class:`DataDelta`) and/or edge add/drop patches
    (:class:`EdgePatch`); duals survive the edge relabeling through
    :func:`repro_torch.core.partition.transfer_edge_duals`.
  * ``solve(id)``                         — warm-started solve; returns
    a :class:`SolveResponse` carrying the eq.-11 residual certificate.
  * ``solve_path(id, lams)``              — batched lambda sweep.
  * ``close(id)``                         — evict the session.

Every response reports residual / iterations / cache / timing
diagnostics, and per-tenant
:class:`~repro_torch.serving.ledger.ServiceLedger` instances meter the
request stream the way the federated ``CommLedger`` meters bits on the
wire.  A request reads its answer's scalars in one transfer
(:func:`_to_host`), besides a tol solve's own fetch.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch import obs
from repro_torch.api.backends import _graph_layout, _should_fuse
from repro_torch.api.problem import Problem, SolverConfig
from repro_torch.api.solver import Solver, solve_path as _solve_path
from repro_torch.core.graph import build_graph
from repro_torch.core.partition import transfer_edge_duals
from repro_torch.device import to_host
from repro_torch.engine import capped as _capped
from repro_torch.serving.cache import Plan, PlanCache, PlanKey
from repro_torch.serving.ledger import ServiceLedger

#: Service-wide solve defaults: tol-certified runs at the empirically
#: reachable 1e-3 residual (EXPERIMENTS.md: small-lambda regimes
#: plateau above 1e-4), over-relaxed, chunked every 25 iterations.
DEFAULT_CONFIG = SolverConfig(num_iters=6000, rho=1.9, metric_every=25,
                              tol=1e-3, record_residual=True,
                              backend="dense")


@dataclasses.dataclass(frozen=True)
class DataDelta:
    """Per-node data replacement: new measurements for ``nodes``.

    Each non-None field carries one leading row per entry of ``nodes``
    and *replaces* that node's rows of the corresponding
    :class:`~repro_torch.core.losses.NodeData` array — x: (k, m_max, n),
    y: (k, m_max), sample_mask: (k, m_max), labeled_mask: (k,).
    """

    nodes: tuple[int, ...]
    x: np.ndarray | None = None
    y: np.ndarray | None = None
    sample_mask: np.ndarray | None = None
    labeled_mask: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class EdgePatch:
    """Edge add/drop patch against a session's empirical graph.

    ``add`` holds (i, j, weight) triples, ``drop`` holds (i, j) pairs
    (either orientation; the graph is undirected).  The node set is
    fixed — patches may only rewire existing nodes.
    """

    add: tuple[tuple[int, int, float], ...] = ()
    drop: tuple[tuple[int, int], ...] = ()


@dataclasses.dataclass
class Session:
    """One live problem: the tenant's graph + data + warm solver state."""

    session_id: str
    tenant: str
    problem: Problem
    config: SolverConfig
    w: torch.Tensor | None = None
    u: torch.Tensor | None = None
    cold_iterations: int | None = None
    solves: int = 0
    updates: int = 0


@dataclasses.dataclass(frozen=True)
class SolveResponse:
    """One answered solve request: estimate + certificate + diagnostics.

    ``residual`` is the last entry of the eq.-11 fixed-point residual
    trace (the optimality certificate the SLA is stated in);
    ``certificate`` carries the eq.-11 dual-infeasibility /
    stationarity diagnostics; ``meets_sla`` is residual <= tol.

    Timing is split: ``seconds`` is the wall clock of the request's first
    run (to the card's last kernel: the device is synchronized before the
    clock stops), ``solve_seconds`` the pure-execution cost (a compiled
    request — the first of its executable signature in the process — is
    re-executed once so the one-time cost can be attributed to
    ``compile_seconds = seconds - solve_seconds``; otherwise
    ``solve_seconds == seconds`` and ``compile_seconds`` is 0).
    ``queue_wait`` counts *submissions* (not wall time) the request sat
    behind in the serving queue; ``batch_width`` is the number of sessions
    solved by the same lane-stacked solve.
    """

    session_id: str
    w: torch.Tensor
    objective: float
    residual: float
    certificate: dict
    lam: float
    tol: float | None
    iterations: int
    warm: bool
    cache_hit: bool
    compiled: bool
    seconds: float
    meets_sla: bool
    solve_seconds: float = 0.0
    compile_seconds: float = 0.0
    queue_wait: int = 0
    batch_width: int = 1


class SolveService:
    """Multi-tenant warm-started solve service over a shared plan cache."""

    def __init__(self, config: SolverConfig | None = None,
                 max_plans: int = 64):
        cfg = config if config is not None else DEFAULT_CONFIG
        if cfg.backend not in ("dense", "pallas"):
            raise ValueError(
                "SolveService serves the single-program engines; backend "
                f"must be 'dense' or 'pallas', got {cfg.backend!r}")
        self.config = cfg
        self.plans = PlanCache(max_entries=max_plans)
        self._sessions: dict[str, Session] = {}
        self._ledgers: dict[str, ServiceLedger] = {}

    # -- bookkeeping ---------------------------------------------------------
    def ledger(self, tenant: str) -> ServiceLedger:
        led = self._ledgers.get(tenant)
        if led is None:
            led = self._ledgers[tenant] = ServiceLedger(tenant=tenant)
        return led

    def summary(self) -> dict:
        """Service-wide report: per-tenant ledgers + plan-cache stats."""
        return {
            "tenants": {t: led.summary()
                        for t, led in sorted(self._ledgers.items())},
            "plan_cache": self.plans.summary(),
            "sessions": float(len(self._sessions)),
        }

    def session(self, session_id: str) -> Session:
        try:
            return self._sessions[session_id]
        except KeyError:
            raise KeyError(f"unknown session {session_id!r}") from None

    # -- plan persistence ----------------------------------------------------
    def save_plans(self, path: str) -> dict[str, int]:
        """Persist the plan cache (layouts + RCM orders) to ``path``.

        A restarted service calls :meth:`load_plans` and skips
        re-planning for every structure saved here (it still pays each
        signature's first solve — loaded kernels die with the process).
        """
        return self.plans.save(path)

    def load_plans(self, path: str, device=None) -> dict[str, int]:
        """Restore plans saved by :meth:`save_plans` (hash-validated; by
        either package), their layouts on ``device`` (``None`` =
        CUDA)."""
        return self.plans.load(path, device=device)

    # -- session lifecycle ---------------------------------------------------
    def create_session(self, tenant: str, problem: Problem,
                       config: SolverConfig | None = None) -> str:
        """Admit ``problem`` for ``tenant``; returns the session id.

        Sessions are keyed by tenant + graph structure hash (with a
        ``#k`` suffix when a tenant serves the same structure twice).
        """
        cfg = config if config is not None else self.config
        base = f"{tenant}/{problem.graph.structure_hash()[:12]}"
        session_id, k = base, 1
        while session_id in self._sessions:
            session_id = f"{base}#{k}"
            k += 1
        self._sessions[session_id] = Session(
            session_id=session_id, tenant=tenant, problem=problem,
            config=cfg)
        led = self.ledger(tenant)
        led.requests += 1
        led.creates += 1
        return session_id

    def update_session(self, session_id: str,
                       delta: DataDelta | None = None,
                       patch: EdgePatch | None = None,
                       lam: float | None = None) -> None:
        """Apply data deltas / edge patches; warm state survives.

        Data deltas replace node rows in place; edge patches rebuild the
        graph (new structure hash — the next solve re-plans) and carry
        the cached duals across the edge relabeling, zero-filling the
        rows of added edges.  ``lam`` retargets the TV strength.
        """
        sess = self.session(session_id)
        if delta is not None:
            sess.problem = dataclasses.replace(
                sess.problem, data=_apply_delta(sess.problem.data, delta))
        if patch is not None:
            old_graph = sess.problem.graph
            new_graph = _apply_patch(old_graph, patch)
            if sess.u is not None:
                sess.u = torch.from_numpy(transfer_edge_duals(
                    old_graph, new_graph, sess.u)).to(sess.u.device)
            # the new structure's hash (a host read of the graph) is
            # taken here, with the update, not by the next request
            new_graph.structure_hash()
            sess.problem = dataclasses.replace(sess.problem,
                                               graph=new_graph)
        if lam is not None:
            sess.problem = sess.problem.with_lam(float(lam))
        if patch is not None or lam is not None:
            # the cold baseline measured a *different* problem (other
            # structure / other lambda); the next cold-reference solve
            # re-establishes it, so warm_iteration_ratio never mixes
            sess.cold_iterations = None
        sess.updates += 1
        led = self.ledger(sess.tenant)
        led.requests += 1
        led.updates += 1

    def close(self, session_id: str) -> None:
        sess = self._sessions.pop(session_id, None)
        if sess is None:
            raise KeyError(f"unknown session {session_id!r}")
        led = self.ledger(sess.tenant)
        led.requests += 1
        led.closes += 1

    # -- solving -------------------------------------------------------------
    def _plan(self, problem: Problem, config: SolverConfig,
              sig: tuple | None = None, *,
              lanes: int = 1) -> tuple[Plan, bool, bool]:
        """Look up (or build) the plan of ``problem``.  The fused gate
        takes the request's lane count (a path's lambdas), as the solve
        will.  A built layout is the one the fused solve itself plans
        and caches (``api.backends._graph_layout``, planned by the gate
        with the loss's window hint), so a 1M graph is planned once, not
        twice as a hint-less planning here would."""
        key = PlanKey.for_problem(problem, config)

        def build() -> Plan:
            layout = None
            if (config.backend == "pallas"
                    and _should_fuse(problem, config, lanes=lanes)
                    and problem.graph.num_edges):
                layout = _graph_layout(problem.graph)
            return Plan(key=key, layout=layout)

        return self.plans.get_or_build(key, build, sig=sig)

    def _with_plan(self, problem: Problem, plan: Plan) -> Problem:
        if plan.layout is None or problem.graph.layout is plan.layout:
            return problem
        return dataclasses.replace(
            problem,
            graph=dataclasses.replace(problem.graph, layout=plan.layout))

    def solve(self, session_id: str, *, w_true=None, cold: bool = False,
              queue_wait: int = 0) -> SolveResponse:
        """Solve the session's problem, warm-starting from cached state.

        ``cold=True`` forces a from-zeros solve (benchmark baseline);
        warm starts re-project the cached duals onto the current
        lambda's feasible box, so a lambda retarget stays feasible.
        ``queue_wait`` is forwarded verbatim into the response and the
        request event (the serving queue passes each ticket's measured
        wait; direct callers leave it 0).
        """
        sess = self.session(session_id)
        cfg = sess.config
        plan, hit, compiled = self._plan(sess.problem, cfg)
        problem = self._with_plan(sess.problem, plan)

        warm = sess.w is not None and not cold

        def warm_state():
            if not warm:
                return None, None
            # copies for every run: a backend may alias a warm start
            # (``torch.as_tensor``) and write the state it is given
            w0 = sess.w.clone()
            u0 = problem.regularizer.project_dual(
                sess.u.clone(), problem.graph, problem.lam)
            return w0, u0

        w0, u0 = warm_state()
        t0 = time.perf_counter()
        result = Solver(cfg).run(problem, w0=w0, u0=u0, w_true=w_true)
        _to_host(result.w, read=False)
        seconds = time.perf_counter() - t0
        solve_seconds, compile_seconds = seconds, 0.0
        if compiled:
            # the signature is warm now: one re-execution isolates the
            # pure run cost, attributing the remainder to the first
            # solve's one-time cost (the solve is deterministic, so the
            # re-run's result is the one returned)
            w0, u0 = warm_state()
            t1 = time.perf_counter()
            result = Solver(cfg).run(problem, w0=w0, u0=u0,
                                     w_true=w_true)
            _to_host(result.w, read=False)
            solve_seconds = time.perf_counter() - t1
            compile_seconds = max(seconds - solve_seconds, 0.0)

        iterations = int(result.diagnostics.get(
            "iterations", _capped(cfg.num_iters, cfg.metric_every)))
        sess.w, sess.u = result.w, result.u
        sess.solves += 1
        cold_ref = sess.cold_iterations if warm else None
        if not warm:
            # only true from-zeros solves (first solve, forced cold,
            # post-update-reset) may define the cold baseline — a warm
            # solve standing in as baseline would fake the ratio
            sess.cold_iterations = iterations

        led = self.ledger(sess.tenant)
        led.requests += 1
        led.record_solve(cache_hit=hit, compiled=compiled,
                         iterations=iterations, cold_ref=cold_ref)
        return self._response(sess, result, warm=warm, cache_hit=hit,
                              compiled=compiled, iterations=iterations,
                              seconds=seconds,
                              solve_seconds=solve_seconds,
                              compile_seconds=compile_seconds,
                              queue_wait=queue_wait)

    def solve_path(self, session_id: str, lams,
                   *, w_true=None) -> list[SolveResponse]:
        """Batched lambda sweep against the session (one lane a lambda).

        Path solves are read-only — they answer "what would the estimate
        be at these lambdas" without disturbing the session's warm state
        or its current lambda.
        """
        sess = self.session(session_id)
        lams = np.asarray(lams, np.float32).reshape(-1)
        # fixed-length lane sweep: tol off, residual trace on
        cfg = sess.config.replace(tol=None, record_residual=True,
                                  continuation=False)
        plan, hit, compiled = self._plan(sess.problem, cfg,
                                         lanes=len(lams))
        problem = self._with_plan(sess.problem, plan)

        t0 = time.perf_counter()
        result = _solve_path(problem, lams, cfg, w_true=w_true)
        _to_host(result.w, read=False)
        total = time.perf_counter() - t0
        npts = max(len(lams), 1)
        seconds = total / npts
        solve_seconds, compile_seconds = seconds, 0.0
        if compiled:
            # as in solve(): re-execute the warm signature to split the
            # one-time cost out of the per-point timing
            t1 = time.perf_counter()
            result = _solve_path(problem, lams, cfg, w_true=w_true)
            _to_host(result.w, read=False)
            exec_total = time.perf_counter() - t1
            solve_seconds = exec_total / npts
            compile_seconds = max(total - exec_total, 0.0) / npts

        iters = _capped(cfg.final_iters, cfg.metric_every)
        warm_iters = _capped(cfg.warm_iters, cfg.metric_every)
        led = self.ledger(sess.tenant)
        led.requests += 1
        led.record_path(points=len(lams), point_iterations=iters,
                        warm_iterations=warm_iters, cache_hit=hit,
                        compiled=compiled)
        responses = []
        for i in range(len(lams)):
            point = _lane(result, i)
            responses.append(self._response(
                sess, point, warm=False, cache_hit=hit,
                compiled=compiled if i == 0 else False, iterations=iters,
                seconds=seconds, tol=sess.config.tol,
                solve_seconds=solve_seconds,
                compile_seconds=compile_seconds if i == 0 else 0.0,
                kind="path"))
        return responses

    def _response(self, sess: Session, result, *, warm: bool,
                  cache_hit: bool, compiled: bool, iterations: int,
                  seconds: float, tol: float | None = ...,
                  solve_seconds: float | None = None,
                  compile_seconds: float = 0.0, queue_wait: int = 0,
                  batch_width: int = 1,
                  kind: str = "solve") -> SolveResponse:
        tol = sess.config.tol if tol is ... else tol
        names = [k for k, v in result.diagnostics.items()
                 if k != "iterations" and not k.startswith("halo_")
                 and np.ndim(v) == 0]
        # the answer's scalars in one transfer: the residual, the
        # objective and the certificate, stacked on the device
        scalars = [result.objective[-1]] + [result.diagnostics[k]
                                            for k in names]
        if result.residual is not None:
            scalars.append(result.residual[-1])
        host = _to_host(torch.stack([torch.as_tensor(
            x, dtype=torch.float32, device=result.w.device).reshape(())
            for x in scalars]))
        objective = host[0]
        certificate = dict(zip(names, host[1:1 + len(names)]))
        residual = (host[-1] if result.residual is not None
                    else float("nan"))
        resp = SolveResponse(
            session_id=sess.session_id,
            w=result.w,
            objective=objective,
            residual=residual,
            certificate=certificate,
            lam=float(result.lam),
            tol=tol,
            iterations=iterations,
            warm=warm,
            cache_hit=cache_hit,
            compiled=compiled,
            seconds=seconds,
            meets_sla=bool(tol is not None and residual <= tol),
            solve_seconds=(seconds if solve_seconds is None
                           else solve_seconds),
            compile_seconds=compile_seconds,
            queue_wait=queue_wait,
            batch_width=batch_width,
        )
        if obs.enabled():
            self._record_obs(sess, resp, kind=kind)
        return resp

    def _record_obs(self, sess: Session, resp: SolveResponse, *,
                    kind: str) -> None:
        """Meter one response into the obs registry + event log."""
        obs.counter("repro_serving_requests_total",
                    help="solve responses by tenant and kind",
                    tenant=sess.tenant, kind=kind).inc()
        obs.histogram("repro_serving_request_seconds",
                      help="request wall clock (compile included)"
                      ).observe(resp.seconds)
        obs.histogram("repro_serving_execute_seconds",
                      help="pure-execution solve seconds"
                      ).observe(resp.solve_seconds)
        if resp.compile_seconds:
            obs.counter("repro_serving_compile_seconds_total",
                        help="seconds spent in XLA traces"
                        ).inc(resp.compile_seconds)
        obs.histogram("repro_serving_queue_wait",
                      help="submissions a request waited behind",
                      buckets=obs.COUNT_BUCKETS
                      ).observe(float(resp.queue_wait))
        obs.histogram("repro_serving_batch_width",
                      help="sessions per batched executable",
                      buckets=obs.COUNT_BUCKETS
                      ).observe(float(resp.batch_width))
        obs.counter("repro_serving_sla_total",
                    help="responses by SLA outcome",
                    outcome="met" if resp.meets_sla else "missed").inc()
        obs.counter("repro_serving_iterations_total",
                    help="solver iterations run by the service"
                    ).inc(float(resp.iterations))
        self.ledger(sess.tenant).export_obs()
        obs.events.record_request(
            event=kind, tenant=sess.tenant, session=sess.session_id,
            queue_wait=resp.queue_wait, batch_width=resp.batch_width,
            warm=resp.warm, cache_hit=resp.cache_hit,
            compiled=resp.compiled, iterations=resp.iterations,
            residual=resp.residual, meets_sla=resp.meets_sla,
            seconds=resp.seconds, solve_seconds=resp.solve_seconds,
            compile_seconds=resp.compile_seconds, lam=resp.lam,
            tol=resp.tol)


# ---------------------------------------------------------------------------
# Patch application helpers (host-side)
# ---------------------------------------------------------------------------

def _to_host(t: torch.Tensor, *, read: bool = True):
    """The serving layer's one way to the host.  With ``read``: ``t``'s
    values as a list, in one transfer, counted in ``_to_host.reads`` (a
    response's scalars; the reference reads them with ``float``, outside
    the solver's transfer meter, so this read is not a ``device_fetch``).
    Without: a wait for the card's work behind ``t`` (a request's clock
    stops when its solve has run, not when it was enqueued), no transfer.
    On the card it lifts ``torch.cuda.set_sync_debug_mode`` for its own
    call, as ``device_fetch`` does, so a request checked under "error"
    fails only on another sync.  No wait on the CPU."""
    if read:
        _to_host.reads += 1
    if t.device.type != "cuda":
        return t.numpy().tolist() if read else None
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        if read:
            return t.cpu().numpy().tolist()
        torch.cuda.synchronize(t.device)
        return None
    finally:
        torch.cuda.set_sync_debug_mode(mode)


_to_host.reads = 0


def _lane(result, i: int):
    """Lane ``i`` of a lane-stacked SolveResult (every tensor leaf and
    every diagnostic indexed at ``i``)."""
    def pick(a):
        return a[i] if isinstance(a, torch.Tensor) else a
    return dataclasses.replace(
        result, w=pick(result.w), u=pick(result.u),
        objective=pick(result.objective), mse=pick(result.mse),
        lam=pick(result.lam), residual=pick(result.residual),
        diagnostics={k: pick(v) for k, v in result.diagnostics.items()})


def _apply_delta(data, delta: DataDelta):
    """Row-replace ``delta.nodes`` in each provided NodeData field (into
    new tensors: sessions may share their data)."""
    nodes = torch.as_tensor(np.asarray(delta.nodes, np.int64),
                            device=data.x.device)
    out = data
    for field in ("x", "y", "sample_mask", "labeled_mask"):
        rows = getattr(delta, field)
        if rows is None:
            continue
        cur = getattr(out, field)
        rows = torch.as_tensor(np.asarray(rows), dtype=cur.dtype).to(
            cur.device)
        if tuple(rows.shape) != (len(delta.nodes),) + tuple(cur.shape[1:]):
            raise ValueError(
                f"DataDelta.{field} must have shape "
                f"{(len(delta.nodes),) + tuple(cur.shape[1:])}, got "
                f"{tuple(rows.shape)}")
        out = dataclasses.replace(out, **{field: cur.index_copy(0, nodes,
                                                               rows)})
    return out


def _apply_patch(graph, patch: EdgePatch):
    """Rebuild the graph with ``patch`` applied (canonicalized edges).

    Drops first, then adds in patch order with *last-write-wins*
    semantics: adding an edge that already exists (or was dropped and
    re-added within the same patch) re-weights it.  ``build_graph``'s
    stable dedupe keeps the first duplicate, so appending and rebuilding
    would silently keep the stale weight instead.  Self-loop adds are
    rejected here, naming the offending pair, rather than surfacing as
    a late anonymous build_graph error.
    """
    V = graph.num_nodes
    edges: "dict[tuple[int, int], float]" = {
        (int(s), int(d)): float(w)
        for s, d, w in zip(to_host(graph.src).astype(np.int64),
                           to_host(graph.dst).astype(np.int64),
                           to_host(graph.weights).astype(np.float32))}
    for i, j in patch.drop:
        edges.pop((min(i, j), max(i, j)), None)
    for i, j, w in patch.add:
        if i == j:
            raise ValueError(
                f"EdgePatch.add contains the self-loop ({i}, {j}); the "
                "empirical graph couples distinct local datasets")
        if not (0 <= i < V and 0 <= j < V):
            raise ValueError(f"edge ({i}, {j}) outside the node set "
                             f"[0, {V})")
        edges[(min(i, j), max(i, j))] = float(w)
    if edges:
        items = sorted(edges.items())
        pairs = np.asarray([k for k, _ in items], np.int64)
        wts = np.asarray([w for _, w in items], np.float32)
    else:
        pairs = np.zeros((0, 2), np.int64)
        wts = np.zeros((0,), np.float32)
    return build_graph(pairs, wts, V, device=graph.device)

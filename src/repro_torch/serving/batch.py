"""Batched multi-session solves: group by exec-sig, solve as lanes once.

The port's ``repro.serving.batch``.  The paper's workload is *many*
local datasets coupled over empirical graphs; the serving twin of that
is many tenants holding structurally similar sessions.  Two sessions
whose :attr:`PlanKey.exec_sig` match (same loss/regularizer templates,
same backend, same array shapes) can run as one lane-stacked
dense-engine solve — stacked ``(w0, u0, data, lam)`` and even stacked
*graph structure arrays* (the lane-stacked executor takes src/dst/
weights per lane), with ``batched_affine`` taking one P per lane and
``tv_prox`` every lane in one launch on ``backend="pallas"``, and
per-session residual certificates split back out (the reference vmaps).

:func:`solve_batch` is the entry point: it groups the requests
(:func:`group_requests`), runs each multi-member group through
:func:`repro_torch.api.solver.solve_many`, falls back to the sequential
:meth:`SolveService.solve` for singleton groups, and keeps every
session/ledger side effect identical to the sequential path — warm
state updated, cold baselines respected, plan hits and the *batch*
signature's compile metered per session.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

from repro_torch.api.solver import solve_many
from repro_torch.engine import capped as _capped
from repro_torch.serving.cache import PlanKey
from repro_torch.serving.service import (SolveResponse, SolveService,
                                         _to_host)


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One pending solve: a session id plus the cold-start flag.

    ``queue_wait`` is the number of submissions the request sat behind
    in the serving queue (the queue's count-based clock; 0 for direct
    calls) — carried through to the response and its request event.
    """

    session_id: str
    cold: bool = False
    queue_wait: int = 0


def _as_request(req) -> SolveRequest:
    return req if isinstance(req, SolveRequest) else SolveRequest(str(req))


def group_requests(service: SolveService,
                   requests) -> list[list[SolveRequest]]:
    """Partition requests into lane-stackable groups, preserving order.

    Group key = (exec_sig, config): exec-sig equality guarantees every
    array shape matches (so the problems stack), and config equality
    guarantees one loop shape.  Sessions with *different graph
    structures* land in the same group — structure arrays stack per
    lane.
    """
    groups: "OrderedDict[tuple, list[SolveRequest]]" = OrderedDict()
    for req in map(_as_request, requests):
        sess = service.session(req.session_id)
        key = PlanKey.for_problem(sess.problem, sess.config)
        groups.setdefault((key.exec_sig, sess.config), []).append(req)
    return list(groups.values())


def solve_batch(service: SolveService, requests,
                *, w_true=None) -> list[SolveResponse]:
    """Solve all ``requests`` (session ids or :class:`SolveRequest`),
    batching exec-sig-matched groups into single lane-stacked solves.

    Returns responses in request order.  Singleton groups take the
    sequential :meth:`SolveService.solve` path (a batch of one would be
    metered as another signature for nothing, as in the reference).
    """
    del w_true  # reserved; serving solves carry no ground truth
    requests = [_as_request(r) for r in requests]
    groups: "OrderedDict[tuple, list[int]]" = OrderedDict()
    for i, req in enumerate(requests):
        sess = service.session(req.session_id)
        key = PlanKey.for_problem(sess.problem, sess.config)
        groups.setdefault((key.exec_sig, sess.config), []).append(i)
    responses: dict[int, SolveResponse] = {}
    for idxs in groups.values():
        if len(idxs) == 1:
            req = requests[idxs[0]]
            responses[idxs[0]] = service.solve(req.session_id,
                                               cold=req.cold,
                                               queue_wait=req.queue_wait)
        else:
            group = [requests[i] for i in idxs]
            for i, resp in zip(idxs, _solve_group(service, group)):
                responses[i] = resp
    return [responses[i] for i in range(len(requests))]


def _solve_group(service: SolveService,
                 group: list[SolveRequest]) -> list[SolveResponse]:
    """One lane-stacked solve for a multi-member exec-sig group."""
    sessions = [service.session(req.session_id) for req in group]
    cfg = sessions[0].config
    B = len(group)

    # per-session plan lookups meter the *batch* signature: a B-lane
    # solve is another signature than the singleton one, shared by the
    # whole group — the first lookup that finds it new reports the
    # compile
    batch_sig = ("batch", B) + PlanKey.for_problem(
        sessions[0].problem, cfg).exec_sig
    lookups = [service._plan(sess.problem, cfg, sig=batch_sig)
               for sess in sessions]

    problems, warms = [], []
    for sess, req in zip(sessions, group):
        warms.append(sess.w is not None and not req.cold)
        problems.append(sess.problem)

    def warm_starts():
        # fresh copies per run: the compile/execute split below runs
        # twice, and no run may write a session's cached state
        w0s, u0s = [], []
        for sess, problem, warm in zip(sessions, problems, warms):
            if warm:
                w0s.append(sess.w.clone())
                u0s.append(problem.regularizer.project_dual(
                    sess.u.clone(), problem.graph, problem.lam))
            else:
                w0s.append(None)
                u0s.append(None)
        return w0s, u0s

    w0s, u0s = warm_starts()
    t0 = time.perf_counter()
    results = solve_many(problems, cfg, w0s=w0s, u0s=u0s)
    _to_host(results[-1].w, read=False)
    total = time.perf_counter() - t0
    seconds = total / B                        # amortized per session
    solve_seconds, compile_seconds = seconds, 0.0
    if any(compiled for _, _, compiled in lookups):
        # the group shares one signature; re-execute it warm to split
        # the one-time cost out of the per-session timing (as in
        # SolveService.solve — deterministic, second result returned)
        w0s, u0s = warm_starts()
        t1 = time.perf_counter()
        results = solve_many(problems, cfg, w0s=w0s, u0s=u0s)
        _to_host(results[-1].w, read=False)
        exec_total = time.perf_counter() - t1
        solve_seconds = exec_total / B
        compile_seconds = max(total - exec_total, 0.0) / B

    iterations = int(results[0].diagnostics.get(
        "iterations", _capped(cfg.num_iters, cfg.metric_every)))
    responses = []
    for sess, req, result, warm, (plan, hit, compiled) in zip(
            sessions, group, results, warms, lookups):
        sess.w, sess.u = result.w, result.u
        sess.solves += 1
        cold_ref = sess.cold_iterations if warm else None
        if not warm:
            sess.cold_iterations = iterations
        led = service.ledger(sess.tenant)
        led.requests += 1
        led.record_solve(cache_hit=hit, compiled=compiled,
                         iterations=iterations, cold_ref=cold_ref)
        responses.append(service._response(
            sess, result, warm=warm, cache_hit=hit, compiled=compiled,
            iterations=iterations, seconds=seconds,
            solve_seconds=solve_seconds,
            compile_seconds=compile_seconds if compiled else 0.0,
            queue_wait=req.queue_wait, batch_width=B))
    return responses

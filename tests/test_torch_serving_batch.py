"""The port's batched serving against the reference's, on the CPU.

Ports of the 12 tests of ``tests/test_serving_batch.py`` on
``repro_torch`` with the reference's ``CFG`` unchanged: ``solve_many``
parity with sequential solves (shared iteration count, per-problem
certificates, different structures of one shape, warm starts, refused
batches), ``solve_batch`` parity with the sequential service (warm
state, cold baselines, the batch signature's compile metered once per
width, singleton fallback, request order) and the serving queue
(``max_batch`` / ``max_wait_requests`` windows, admission control).
And the same seeded requests through ``repro.serving``: ``solve_batch``
responses with ``w`` within 1e-4 of the reference's and iterations,
cache hits, compiles and ledger summaries equal; a queue's flushes and
stats equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import (Problem, Solver, SolverConfig,   # noqa: E402
                             solve_many)
from repro_torch.core.graph import chain_graph                # noqa: E402
from repro_torch.core.losses import NodeData                  # noqa: E402
from repro_torch.serving import (ServingQueue, SolveRequest,  # noqa: E402
                                 SolveService, group_requests, solve_batch)

CFG = SolverConfig(num_iters=4000, rho=1.9, metric_every=10, tol=1e-3,
                   record_residual=True, backend="dense")


def _chain_arrays(v, n, seed):
    rng = np.random.default_rng(seed)
    w_true = np.where(np.arange(v)[:, None] < v // 2, 1.0, -1.0)
    w_true = np.broadcast_to(w_true, (v, n)).astype(np.float32)
    x = rng.standard_normal((v, 4, n)).astype(np.float32)
    y = np.einsum("vmn,vn->vm", x, w_true)
    y += 0.01 * rng.standard_normal(y.shape).astype(np.float32)
    return x, y


def _chain_problem(v=24, n=2, seed=0, lam=5e-2, weight=1.0):
    x, y = _chain_arrays(v, n, seed)
    g = chain_graph(np.random.default_rng(seed), v, weight=weight,
                    device="cpu")
    data = NodeData(x=torch.from_numpy(x), y=torch.from_numpy(y),
                    sample_mask=torch.ones((v, 4)),
                    labeled_mask=torch.ones(v))
    return Problem.create(g, data, lam=lam, device="cpu")


def _j_chain_problem(v=24, n=2, seed=0, lam=5e-2, weight=1.0):
    import jax.numpy as jnp
    from repro.api import Problem as JProblem
    from repro.core.graph import chain_graph as j_chain
    from repro.core.losses import NodeData as JNodeData

    x, y = _chain_arrays(v, n, seed)
    g = j_chain(np.random.default_rng(seed), v, weight=weight)
    data = JNodeData(x=jnp.asarray(x), y=jnp.asarray(y),
                     sample_mask=jnp.ones((v, 4), jnp.float32),
                     labeled_mask=jnp.ones(v, jnp.float32))
    return JProblem.create(g, data, lam=lam)


def _j_config(cfg: SolverConfig):
    from repro.api import SolverConfig as JConfig
    return JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)
                      if f.name not in ("federated", "clip_fn",
                                        "affine_fn")})


# ---------------------------------------------------------------------------
# solve_many: the lane-stacked multi-problem entry point
# ---------------------------------------------------------------------------

def test_solve_many_matches_sequential():
    problems = [_chain_problem(seed=s) for s in range(4)]
    batched = solve_many(problems, CFG)
    assert len(batched) == 4
    iters = {r.diagnostics["iterations"] for r in batched}
    assert len(iters) == 1                       # batch-granular stopping
    for p, r in zip(problems, batched):
        seq = Solver(CFG).run(p)
        assert float(r.residual[-1]) <= CFG.tol  # per-problem certificate
        np.testing.assert_allclose(r.w.numpy(), seq.w.numpy(), atol=5e-3)
        # the batch runs at least as long as the slowest member, so the
        # batched estimate is at least as converged as the sequential one
        assert r.diagnostics["iterations"] >= seq.diagnostics["iterations"]


def test_solve_many_batches_different_structures():
    # same shapes, *different* structure hashes (edge weights differ):
    # structure arrays stack per lane, so these batch fine
    problems = [_chain_problem(weight=1.0), _chain_problem(weight=2.0)]
    assert (problems[0].graph.structure_hash()
            != problems[1].graph.structure_hash())
    batched = solve_many(problems, CFG)
    for p, r in zip(problems, batched):
        seq = Solver(CFG).run(p)
        np.testing.assert_allclose(r.w.numpy(), seq.w.numpy(), atol=5e-3)


def test_solve_many_warm_starts_and_traces():
    problems = [_chain_problem(seed=s) for s in range(3)]
    cfg = CFG.replace(tol=None, num_iters=50, metric_every=1)
    for r in solve_many(problems, cfg):
        assert r.objective.shape == (50,)        # fixed-length traces
        assert r.residual.shape == (50,)
    # warm-starting each problem from its own certified solution
    # re-certifies at the metric_every iteration floor
    cold = solve_many(problems, CFG)
    warm = solve_many(problems, CFG, w0s=[r.w for r in cold],
                      u0s=[r.u for r in cold])
    assert all(r.diagnostics["iterations"] == CFG.metric_every
               for r in warm)


def test_solve_many_rejects_bad_batches():
    with pytest.raises(ValueError, match=r"problems\[1\]"):
        solve_many([_chain_problem(v=24), _chain_problem(v=32)], CFG)
    with pytest.raises(NotImplementedError, match="backend"):
        solve_many([_chain_problem()], CFG.replace(backend="sharded"))
    with pytest.raises(NotImplementedError, match="continuation"):
        solve_many([_chain_problem()], CFG.replace(continuation=True))
    assert solve_many([], CFG) == []


# ---------------------------------------------------------------------------
# solve_batch: the serving fast path
# ---------------------------------------------------------------------------

def _service_with_sessions(num=4, **kw):
    svc = SolveService(config=CFG)
    sids = [svc.create_session(f"t{i % 2}", _chain_problem(seed=i, **kw))
            for i in range(num)]
    return svc, sids


def test_group_requests_by_exec_sig():
    svc = SolveService(config=CFG)
    a = svc.create_session("t", _chain_problem(v=24))
    b = svc.create_session("t", _chain_problem(v=24, seed=1))
    c = svc.create_session("t", _chain_problem(v=32))
    groups = group_requests(svc, [a, b, c])
    assert [len(g) for g in groups] == [2, 1]    # v=32 cannot stack


def test_solve_batch_matches_sequential_service():
    svc_b, sids_b = _service_with_sessions()
    svc_s, sids_s = _service_with_sessions()
    batched = solve_batch(svc_b, sids_b)
    sequential = [svc_s.solve(sid) for sid in sids_s]
    for rb, rs in zip(batched, sequential):
        assert rb.meets_sla and rs.meets_sla
        np.testing.assert_allclose(rb.w.numpy(), rs.w.numpy(), atol=5e-3)
    # side effects mirror the sequential path: warm state cached, cold
    # baselines set, one solve per session
    for sid, rb in zip(sids_b, batched):
        sess = svc_b.session(sid)
        assert sess.solves == 1 and sess.w is not None
        assert sess.cold_iterations == rb.iterations
    # second round is warm everywhere and certifies at the iteration floor
    warm = solve_batch(svc_b, sids_b)
    assert all(r.warm and r.meets_sla for r in warm)
    assert all(r.iterations == CFG.metric_every for r in warm)
    # forced cold requests bypass the warm state
    cold = solve_batch(svc_b, [SolveRequest(sid, cold=True)
                               for sid in sids_b])
    assert not any(r.warm for r in cold)


def test_solve_batch_compile_metered_once_per_width():
    svc = SolveService(config=CFG)
    sids = [svc.create_session(f"t{i % 2}",
                               _chain_problem(seed=i, weight=1.0 + 0.5 * i))
            for i in range(4)]
    first = solve_batch(svc, sids)
    # four distinct structures -> four plan misses, but ONE lane-stacked
    # signature: the compile rides the first response only
    assert [r.compiled for r in first] == [True, False, False, False]
    assert [r.cache_hit for r in first] == [False, False, False, False]
    assert svc.plans.misses == 4
    again = solve_batch(svc, sids)
    assert [r.compiled for r in again] == [False, False, False, False]
    assert [r.cache_hit for r in again] == [True, True, True, True]
    # a different batch width is another signature: metered anew
    narrower = solve_batch(svc, sids[:3])
    assert [r.compiled for r in narrower] == [True, False, False]
    # per-tenant ledgers saw every response
    led = {t: svc.ledger(t) for t in ("t0", "t1")}
    assert led["t0"].solves + led["t1"].solves == 11
    assert led["t0"].compiles + led["t1"].compiles == 2


def test_solve_batch_singleton_falls_back_to_sequential():
    svc = SolveService(config=CFG)
    a = svc.create_session("t", _chain_problem(v=24))
    b = svc.create_session("t", _chain_problem(v=32))
    responses = solve_batch(svc, [a, b])         # two singleton groups
    assert all(r.meets_sla for r in responses)
    assert [r.session_id for r in responses] == [a, b]
    # singleton groups meter the *singleton* exec sig (no batch prefix):
    # a later sequential solve of the same shape reports no new compile
    c = svc.create_session("t", _chain_problem(v=24, seed=1))
    assert not svc.solve(c).compiled


def test_solve_batch_preserves_request_order_across_groups():
    svc = SolveService(config=CFG)
    a = svc.create_session("t", _chain_problem(v=24))
    b = svc.create_session("t", _chain_problem(v=32))
    c = svc.create_session("t", _chain_problem(v=24, seed=1))
    responses = solve_batch(svc, [a, b, c])      # interleaved groups
    assert [r.session_id for r in responses] == [a, b, c]


# ---------------------------------------------------------------------------
# ServingQueue: admission + batch window
# ---------------------------------------------------------------------------

def test_queue_flushes_at_max_batch():
    svc, sids = _service_with_sessions()
    q = ServingQueue(svc, max_batch=4, max_wait_requests=100)
    tickets = [q.submit(sid) for sid in sids[:3]]
    assert all(t is not None and not t.done for t in tickets)  # window open
    tickets.append(q.submit(sids[3]))            # 4th submit fills it
    assert all(t.done for t in tickets)
    assert q.flushes == 1 and q.batched == 4 and q.pending() == 0
    assert all(t.response.meets_sla for t in tickets)


def test_queue_flushes_after_max_wait_requests():
    svc, sids = _service_with_sessions()
    q = ServingQueue(svc, max_batch=100, max_wait_requests=3)
    t0 = q.submit(sids[0])
    t1 = q.submit(sids[1])
    assert not t0.done                           # 2 submits: window open
    q.submit(sids[2])                            # 3rd submit -> flush
    assert t0.done and t1.done
    assert q.flushes == 1 and q.batched == 3
    # max_wait_requests=1 degenerates to sequential serving
    q1 = ServingQueue(svc, max_batch=100, max_wait_requests=1)
    assert q1.submit(sids[0]).done
    assert q1.singletons == 1


def test_queue_admission_control():
    svc, sids = _service_with_sessions()
    with pytest.raises(KeyError):
        ServingQueue(svc).submit("nope")
    # per-tenant in-flight cap: t0 owns sids[0] and sids[2]
    q = ServingQueue(svc, max_batch=100, max_wait_requests=100,
                     max_inflight_per_tenant=1)
    assert q.submit(sids[0]) is not None
    assert q.submit(sids[2]) is None             # same tenant, over cap
    assert q.submit(sids[1]) is not None         # other tenant admitted
    assert q.stats()["rejected_tenant"] == 1
    # queue-depth cap
    qf = ServingQueue(svc, max_pending=2, max_batch=100,
                      max_wait_requests=100, max_inflight_per_tenant=10)
    assert qf.submit(sids[0]) is not None
    assert qf.submit(sids[1]) is not None
    assert qf.submit(sids[2]) is None
    assert qf.stats()["rejected_full"] == 1
    # drain answers everything still pending
    tickets = qf.drain()
    assert len(tickets) == 2 and all(t.done for t in tickets)
    assert qf.stats()["pending"] == 0


# ---------------------------------------------------------------------------
# Against the reference: the same requests through repro.serving
# ---------------------------------------------------------------------------

def _batch_rounds(pkg, problems, cfg):
    """Four sessions on two structures of one shape, batched cold, then
    warm, then narrower and forced cold, then a queue's window."""
    svc = pkg.SolveService(config=cfg)
    sids = [svc.create_session(f"t{i % 2}", p) for i, p in
            enumerate(problems)]
    out = pkg.solve_batch(svc, sids)
    out += pkg.solve_batch(svc, sids)
    out += pkg.solve_batch(svc, [pkg.SolveRequest(s, cold=True)
                                 for s in sids[:3]])
    q = pkg.ServingQueue(svc, max_batch=3, max_wait_requests=100)
    tickets = [q.submit(s) for s in sids]
    q.drain()
    out += [t.response for t in tickets if t is not None]
    return out, svc.summary(), q.stats()


@pytest.mark.parametrize("backend", ["dense", "pallas"])
def test_solve_batch_matches_reference(backend):
    """The same batched requests through both packages (``pallas``: the
    unfused lanes, ``batched_affine`` with one P per session): every
    response's ``w`` within 1e-4 of the reference's, iterations, warm
    and cold, cache hits, compiles and batch widths equal; the ledger
    summaries and the queue's stats equal."""
    import repro.serving as jserving
    import repro_torch.serving as tserving

    cfg = CFG.replace(backend=backend)
    specs = [dict(seed=i, weight=1.0 + 0.5 * (i % 2)) for i in range(4)]
    got, got_summary, got_q = _batch_rounds(
        tserving, [_chain_problem(**k) for k in specs], cfg)
    want, want_summary, want_q = _batch_rounds(
        jserving, [_j_chain_problem(**k) for k in specs], _j_config(cfg))
    assert len(got) == len(want) == 15
    for i, (g, w) in enumerate(zip(got, want)):
        for name in ("session_id", "iterations", "warm", "cache_hit",
                     "compiled", "meets_sla", "batch_width", "queue_wait"):
            assert getattr(g, name) == getattr(w, name), (i, name)
        np.testing.assert_allclose(g.w.numpy(), np.asarray(w.w), rtol=0,
                                   atol=1e-4, err_msg=str(i))
    assert got_summary == want_summary
    assert got_q == want_q

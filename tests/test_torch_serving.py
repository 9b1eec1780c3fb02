"""The port's serving layer against the reference's, on the CPU.

Ports of the 26 tests of ``tests/test_serving.py`` on
``repro_torch.serving`` with the reference's ``CFG`` unchanged (sessions,
plan sharing and eviction, dual transfer across edge patches, warm
starts, residual certificates, ledger exactness, edge-patch semantics,
cold baselines, compile accounting, plan persistence), and where a
result can be compared the same seeded inputs through ``repro.serving``:

  * a service's request sequence (cold, data delta, lambda retarget,
    edge patch, path sweep; the dense and the fused ``pallas`` engine):
    every response's ``w`` within 1e-4 of the reference's, iteration
    counts, SLA outcomes, cache hits and compiles, ledger summaries and
    plan-cache counts exactly;
  * ``layout_structure_hash`` equal to the reference's, and
    ``transfer_edge_duals`` bit-equal;
  * plan files across packages both ways: a plan saved by either
    package loads in the other, its layout arrays and structure hash
    equal, and the restored service answers as a cache hit without
    re-planning;
  * ``synthetic_stream`` draws the reference's events from one seed;
  * the telemetry export of a fixed request sequence equals the
    reference's: Prometheus names, labels and values apart from timings.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.api import Problem, Solver, SolverConfig      # noqa: E402
from repro_torch.core.graph import build_graph, chain_graph    # noqa: E402
from repro_torch.core.losses import NodeData                   # noqa: E402
from repro_torch.core.partition import (rcm_order_cached,      # noqa: E402
                                        transfer_edge_duals)
from repro_torch.serving import (DataDelta, EdgePatch, Plan,   # noqa: E402
                                 PlanCache, PlanKey, SolveService,
                                 layout_structure_hash, replay,
                                 synthetic_stream)

# metric_every=10: the residual-check cadence is also the warm-solve
# iteration floor, and the small test chains go cold in ~100 iterations
CFG = SolverConfig(num_iters=4000, rho=1.9, metric_every=10, tol=1e-3,
                   record_residual=True, backend="dense")


def _chain_arrays(v=40, n=2, seed=0, labeled_frac=1.0):
    """The reference test's chain-graph regression instance as numpy
    arrays (changepoint signal): ``(x, y, labeled)``."""
    rng = np.random.default_rng(seed)
    w_true = np.where(np.arange(v)[:, None] < v // 2, 1.0, -1.0)
    w_true = np.broadcast_to(w_true, (v, n)).astype(np.float32)
    x = rng.standard_normal((v, 4, n)).astype(np.float32)
    y = np.einsum("vmn,vn->vm", x, w_true)
    y += 0.01 * rng.standard_normal(y.shape).astype(np.float32)
    labeled = np.ones(v, np.float32)
    if labeled_frac < 1.0:
        labeled[:] = 0.0
        k = max(int(round(labeled_frac * v)), 2)
        labeled[rng.choice(v, size=k, replace=False)] = 1.0
    return x, y, labeled


def _chain_problem(v=40, n=2, seed=0, lam=5e-2, labeled_frac=1.0):
    """Small chain-graph regression instance on the CPU.

    ``labeled_frac < 1`` makes the cold solve slow (estimates must
    propagate along the chain to the unlabeled nodes), the regime where
    warm starts pay off.
    """
    x, y, labeled = _chain_arrays(v, n, seed, labeled_frac)
    g = chain_graph(np.random.default_rng(seed), v, device="cpu")
    data = NodeData(x=torch.from_numpy(x), y=torch.from_numpy(y),
                    sample_mask=torch.ones((v, 4)),
                    labeled_mask=torch.from_numpy(labeled))
    return Problem.create(g, data, lam=lam, device="cpu")


def _j_chain_problem(v=40, n=2, seed=0, lam=5e-2, labeled_frac=1.0):
    """The same instance in the reference package."""
    import jax.numpy as jnp
    from repro.api import Problem as JProblem
    from repro.core.graph import chain_graph as j_chain
    from repro.core.losses import NodeData as JNodeData

    x, y, labeled = _chain_arrays(v, n, seed, labeled_frac)
    g = j_chain(np.random.default_rng(seed), v)
    data = JNodeData(x=jnp.asarray(x), y=jnp.asarray(y),
                     sample_mask=jnp.ones((v, 4), jnp.float32),
                     labeled_mask=jnp.asarray(labeled))
    return JProblem.create(g, data, lam=lam)


def _j_config(cfg: SolverConfig):
    from repro.api import SolverConfig as JConfig
    return JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)
                      if f.name not in ("federated", "clip_fn",
                                        "affine_fn")})


# ---------------------------------------------------------------------------
# Structure hashing + plan cache
# ---------------------------------------------------------------------------

def test_structure_hash_ignores_edge_order_and_data():
    edges = np.array([[0, 1], [1, 2], [0, 3]])
    w = np.ones(3, np.float32)
    g1 = build_graph(edges, w, 4, device="cpu")
    g2 = build_graph(edges[::-1], w, 4, device="cpu")  # same set, reversed
    assert g1.structure_hash() == g2.structure_hash()
    # any structural difference changes the hash
    g3 = build_graph(edges[:2], w[:2], 4, device="cpu")
    g4 = build_graph(edges, np.array([1, 1, 2], np.float32), 4,
                     device="cpu")
    assert g3.structure_hash() != g1.structure_hash()
    assert g4.structure_hash() != g1.structure_hash()


def test_rcm_order_cached_shares_across_isomorphic_graphs():
    edges = np.array([[0, 1], [1, 2], [2, 3], [3, 4]])
    w = np.ones(4, np.float32)
    o1 = rcm_order_cached(build_graph(edges, w, 5, device="cpu"))
    o2 = rcm_order_cached(build_graph(edges, w, 5, device="cpu"))
    assert o1 is o2                              # memoized by structure
    assert not o1.flags.writeable               # shared -> frozen


def test_plan_cache_hits_and_evicts():
    cache = PlanCache(max_entries=2)

    def key(i):
        return PlanKey(structure_hash=f"h{i}", loss="sq", regularizer="tv",
                       backend="dense", shape_sig=(4, 3, 2, 2, 2))

    p0, hit, compiled = cache.get_or_build(key(0), lambda: Plan(key(0)))
    assert (hit, compiled) == (False, True)      # first exec-sig compiles
    _, hit, compiled = cache.get_or_build(key(0), lambda: Plan(key(0)))
    assert (hit, compiled) == (True, False)
    # same exec-sig, new structure: plan miss but no new compile
    _, hit, compiled = cache.get_or_build(key(1), lambda: Plan(key(1)))
    assert (hit, compiled) == (False, False)
    # capacity 2: inserting a third evicts the LRU entry (key 0 was
    # touched last via the hit, so key 1 goes)
    cache.get_or_build(key(0), lambda: Plan(key(0)))
    cache.get_or_build(key(2), lambda: Plan(key(2)))
    assert cache.evictions == 1
    assert key(1) not in cache and key(0) in cache and key(2) in cache
    assert len(cache) == 2


# ---------------------------------------------------------------------------
# Dual transfer across edge patches (permute-helper correctness)
# ---------------------------------------------------------------------------

def test_transfer_edge_duals_identity_and_zero_fill():
    edges = np.array([[0, 1], [1, 2], [2, 3]])
    w = np.ones(3, np.float32)
    g = build_graph(edges, w, 4, device="cpu")
    u = np.arange(6, dtype=np.float32).reshape(3, 2)
    # identity patch: exact carry-over
    np.testing.assert_array_equal(transfer_edge_duals(g, g, u), u)
    # drop the middle edge, add a new one: survivors keep their rows,
    # the new edge starts at zero
    g2 = build_graph(np.array([[0, 1], [2, 3], [0, 3]]),
                     np.ones(3, np.float32), 4, device="cpu")
    u2 = transfer_edge_duals(g, g2, u)
    src2 = torch.stack([g2.src, g2.dst], 1).tolist()
    np.testing.assert_array_equal(u2[src2.index([0, 1])], u[0])
    np.testing.assert_array_equal(u2[src2.index([2, 3])], u[2])
    np.testing.assert_array_equal(u2[src2.index([0, 3])], [0.0, 0.0])


def test_transfer_edge_duals_orientation_flip():
    """Duals live on the oriented difference w_src - w_dst: an edge
    stored with opposite orientations in the two graphs (src/dst
    swapped, as layout relabelings produce) must negate its dual row."""
    edges = np.array([[0, 1], [1, 2]])
    w = np.ones(2, np.float32)
    g = build_graph(edges, w, 3, device="cpu")   # canonical: src < dst
    # the same edges stored in flipped orientation (src > dst), as a
    # relabeled layout would hold them
    g_flip = dataclasses.replace(g, src=g.dst, dst=g.src)
    u = np.array([[1.0, 2.0], [3.0, -4.0]], np.float32)
    # flipped -> canonical: every row negates
    np.testing.assert_array_equal(transfer_edge_duals(g_flip, g, u), -u)
    # canonical -> flipped: negates too; round trip is the identity
    np.testing.assert_array_equal(
        transfer_edge_duals(g, g_flip, transfer_edge_duals(g_flip, g, u)),
        u)
    # mixed orientations: only the flipped row changes sign
    g_mixed = dataclasses.replace(
        g, src=torch.stack([g.src[0], g.dst[1]]),
        dst=torch.stack([g.dst[0], g.src[1]]))
    out = transfer_edge_duals(g_mixed, g, u)
    np.testing.assert_array_equal(out[0], u[0])
    np.testing.assert_array_equal(out[1], -u[1])


def test_transfer_matches_cold_solution_after_chain_patch():
    """Chain-graph patch regression: warm re-solve from transferred
    duals reaches the cold-solve solution to tolerance, in a fraction
    of the iterations."""
    problem = _chain_problem()
    solver = Solver(CFG)
    base = solver.run(problem)

    # patch: cut the chain at the changepoint, bridge two other nodes
    v = problem.graph.num_nodes
    cut = (v // 2 - 1, v // 2)
    patch_edges = torch.stack([problem.graph.src, problem.graph.dst],
                              1).numpy()
    keep = ~np.all(patch_edges == np.asarray(cut), axis=1)
    new_edges = np.concatenate([patch_edges[keep], [[5, 30]]])
    g_new = build_graph(new_edges, np.ones(len(new_edges), np.float32), v,
                        device="cpu")
    patched = dataclasses.replace(problem, graph=g_new)

    cold = solver.run(patched)
    u_warm = torch.from_numpy(transfer_edge_duals(problem.graph, g_new,
                                                  base.u))
    u_warm = patched.regularizer.project_dual(u_warm, g_new, patched.lam)
    warm = solver.run(patched, w0=base.w.clone(), u0=u_warm)

    assert float(warm.residual[-1]) <= CFG.tol
    np.testing.assert_allclose(warm.w.numpy(), cold.w.numpy(), atol=5e-3)
    assert (warm.diagnostics["iterations"]
            <= cold.diagnostics["iterations"])


# ---------------------------------------------------------------------------
# Residual-certified traces (satellite: record_residual)
# ---------------------------------------------------------------------------

def test_record_residual_trace_without_tol():
    problem = _chain_problem()
    cfg = SolverConfig(num_iters=200, rho=1.9, metric_every=25,
                       record_residual=True)
    res = Solver(cfg).run(problem)
    assert res.residual is not None
    assert res.residual.shape == (200 // 25,)
    assert bool(torch.isfinite(res.residual).all())
    # the recorded trace is the per-iteration eq.-11 residual at each
    # metric boundary: strictly positive early, decreasing overall
    trace = res.residual.numpy()
    assert trace[-1] < trace[0]
    # and recording must not perturb the numerics
    plain = Solver(dataclasses.replace(cfg,
                                       record_residual=False)).run(problem)
    assert torch.equal(res.w, plain.w)


def test_tol_runs_always_carry_residual_trace():
    res = Solver(CFG).run(_chain_problem())
    assert res.residual is not None
    assert float(res.residual[-1]) <= CFG.tol


# ---------------------------------------------------------------------------
# SolveService: lifecycle, warm starts, certificates, ledger
# ---------------------------------------------------------------------------

@pytest.fixture()
def service():
    return SolveService(config=CFG)


def test_session_lifecycle(service):
    problem = _chain_problem()
    sid = service.create_session("t", problem)
    assert sid.startswith("t/")
    # same tenant + same structure: distinct session ids
    sid2 = service.create_session("t", problem)
    assert sid2 != sid
    resp = service.solve(sid)
    assert resp.session_id == sid and not resp.warm
    service.close(sid)
    service.close(sid2)
    with pytest.raises(KeyError):
        service.solve(sid)
    with pytest.raises(KeyError):
        service.close(sid)
    with pytest.raises(KeyError):
        service.update_session("nope")


def test_every_response_carries_certificate(service):
    problem = _chain_problem()
    sid = service.create_session("t", problem)
    responses = [service.solve(sid)]
    service.update_session(sid, delta=DataDelta(
        nodes=(0, 1), y=np.zeros((2,) + tuple(problem.data.y.shape[1:]),
                                 np.float32)))
    responses.append(service.solve(sid))
    service.update_session(sid, patch=EdgePatch(drop=((0, 1),),
                                                add=((0, 2, 1.0),)))
    responses.append(service.solve(sid))
    responses.extend(service.solve_path(sid, [1e-2, 5e-2]))
    for resp in responses:
        assert np.isfinite(resp.residual)
        assert resp.residual <= CFG.tol
        assert resp.meets_sla
        assert np.isfinite(resp.certificate["dual_infeasibility"])


def test_warm_restart_beats_cold_on_small_delta(service):
    # a longer, sparsely labeled chain: cold-start iterations grow with
    # the label-propagation distance while a small-delta warm start
    # stays near the fixed point, so the 1/5 ratio has headroom above
    # the metric_every iteration floor
    problem = _chain_problem(v=120, labeled_frac=0.15)
    sid = service.create_session("t", problem)
    cold = service.solve(sid)
    rng = np.random.default_rng(0)
    y = problem.data.y.numpy()
    nodes = (3, 17)
    rows = y[list(nodes)] + 0.02 * rng.standard_normal(
        (2,) + y.shape[1:]).astype(np.float32)
    service.update_session(sid, delta=DataDelta(nodes=nodes, y=rows))
    warm = service.solve(sid)
    assert warm.warm and warm.cache_hit and not warm.compiled
    assert warm.iterations <= cold.iterations / 5
    assert warm.residual <= CFG.tol


def test_request_makes_at_most_two_transfers(service, monkeypatch):
    """A warm request reads nothing on the host but its tol solve's one
    fetch and its answer's one read of the stacked scalars."""
    from repro_torch.engine import loop
    from repro_torch.serving.service import _to_host

    from test_torch_device_stop import no_host_reads

    sid = service.create_session("t", _chain_problem())
    service.solve(sid)
    fetches, reads = loop.device_fetch.calls, _to_host.reads
    with no_host_reads(monkeypatch):
        resp = service.solve(sid)
    assert loop.device_fetch.calls - fetches == 1
    assert _to_host.reads - reads == 1
    assert resp.warm and resp.meets_sla and isinstance(resp.residual, float)


def test_warm_solution_matches_cold_solution(service):
    """Warm and cold solves of the identical post-update problem agree
    to tolerance (the warm path converges to the same fixed point)."""
    problem = _chain_problem()
    sid = service.create_session("t", problem)
    service.solve(sid)
    service.update_session(sid, patch=EdgePatch(drop=((10, 11),)))
    warm = service.solve(sid)
    cold = service.solve(sid, cold=True)
    np.testing.assert_allclose(warm.w.numpy(), cold.w.numpy(), atol=5e-3)


def test_same_structure_different_data_shares_plan(service):
    p1 = _chain_problem(seed=0)
    p2 = _chain_problem(seed=1)                 # new data, same chain
    assert p1.graph.structure_hash() == p2.graph.structure_hash()
    s1 = service.create_session("a", p1)
    s2 = service.create_session("b", p2)
    r1 = service.solve(s1)
    r2 = service.solve(s2)
    assert not r1.cache_hit and r1.compiled
    assert r2.cache_hit and not r2.compiled
    assert len(service.plans) == 1


def test_plan_cache_eviction_under_cap():
    service = SolveService(config=CFG, max_plans=2)
    sids = []
    for v in (24, 32, 40):                      # three structures
        sids.append(service.create_session("t", _chain_problem(v=v)))
        service.solve(sids[-1])
    assert len(service.plans) == 2
    assert service.plans.evictions == 1
    # re-solving the evicted structure is a plan miss, not an error
    hits_before = service.plans.hits
    service.solve(sids[0])
    assert service.plans.hits == hits_before    # warm solve, plan rebuilt
    assert service.plans.misses == 4


def test_ledger_exactness(service):
    problem = _chain_problem()
    sid = service.create_session("t", problem)
    cold = service.solve(sid)
    service.update_session(sid, delta=DataDelta(
        nodes=(2,), y=problem.data.y.numpy()[[2]] + 0.01))
    warm = service.solve(sid)
    service.close(sid)
    led = service.ledger("t")
    assert led.requests == 5        # create+solve+update+solve+close
    assert (led.creates, led.updates, led.solves, led.closes) == (1, 1, 2, 1)
    assert led.cache_misses == 1 and led.cache_hits == 1
    assert led.compiles == 1
    assert led.iterations == cold.iterations + warm.iterations
    assert led.iterations_saved == cold.iterations - warm.iterations
    assert led.summary()["warm_iteration_ratio"] == pytest.approx(
        warm.iterations / cold.iterations)


def test_lam_update_reprojects_duals(service):
    """Retargeting lambda keeps the warm duals feasible (projection) and
    the next response still certifies."""
    sid = service.create_session("t", _chain_problem(lam=5e-2))
    service.solve(sid)
    service.update_session(sid, lam=1e-2)       # tighter dual box
    resp = service.solve(sid)
    assert resp.meets_sla and resp.lam == pytest.approx(1e-2)


def test_synthetic_stream_replay(service):
    problem = _chain_problem()
    sid = service.create_session("t", problem)
    service.solve(sid)
    rng = np.random.default_rng(0)
    events = synthetic_stream(rng, problem.data, problem.graph,
                              num_steps=3, drift_fraction=0.1,
                              drift_scale=0.05, churn_every=2)
    records = replay(service, sid, events)
    assert len(records) == 3
    assert records[1]["structural"]             # churn fired at step 2
    assert all(r["warm_meets_sla"] for r in records)
    sess = service.session(sid)
    assert sess.updates == 3 and sess.solves == 4


# ---------------------------------------------------------------------------
# Edge-patch semantics: last-write-wins reweights, self-loop rejection
# ---------------------------------------------------------------------------

def _edge_weight(graph, i, j):
    lo, hi = min(i, j), max(i, j)
    mask = (graph.src.numpy() == lo) & (graph.dst.numpy() == hi)
    wts = graph.weights.numpy()[mask]
    return float(wts[0]) if wts.size else None


def test_patch_reweight_last_write_wins(service):
    sid = service.create_session("t", _chain_problem())
    g0 = service.session(sid).problem.graph
    assert _edge_weight(g0, 0, 1) == pytest.approx(1.0)
    # adding an existing edge (either orientation) re-weights it;
    # build_graph's first-wins dedupe would keep the stale 1.0 instead
    service.update_session(sid, patch=EdgePatch(add=((1, 0, 3.5),)))
    g1 = service.session(sid).problem.graph
    assert _edge_weight(g1, 0, 1) == pytest.approx(3.5)
    assert g1.num_edges == g0.num_edges          # reweighted, not duplicated
    # duplicate adds within one patch: the last weight wins
    service.update_session(sid, patch=EdgePatch(add=((0, 1, 2.0),
                                                     (0, 1, 7.0))))
    g2 = service.session(sid).problem.graph
    assert _edge_weight(g2, 0, 1) == pytest.approx(7.0)
    assert g2.num_edges == g0.num_edges


def test_patch_drop_then_readd_same_patch(service):
    sid = service.create_session("t", _chain_problem())
    g0 = service.session(sid).problem.graph
    service.update_session(sid, patch=EdgePatch(drop=((0, 1),),
                                                add=((0, 1, 9.0),)))
    g1 = service.session(sid).problem.graph
    assert _edge_weight(g1, 0, 1) == pytest.approx(9.0)
    assert g1.num_edges == g0.num_edges
    assert service.solve(sid).meets_sla          # patched problem certifies


def test_patch_self_loop_rejected(service):
    sid = service.create_session("t", _chain_problem())
    g0 = service.session(sid).problem.graph
    with pytest.raises(ValueError, match=r"\(3, 3\)"):
        service.update_session(sid, patch=EdgePatch(add=((3, 3, 1.0),)))
    with pytest.raises(ValueError, match="outside the node set"):
        service.update_session(sid, patch=EdgePatch(add=((0, 999, 1.0),)))
    # rejected patches leave the session's graph untouched
    assert service.session(sid).problem.graph is g0


# ---------------------------------------------------------------------------
# Cold-baseline hygiene: structure / lambda changes reset it
# ---------------------------------------------------------------------------

def test_cold_baseline_resets_on_structure_change(service):
    sid = service.create_session("t", _chain_problem())
    service.solve(sid)
    sess = service.session(sid)
    assert sess.cold_iterations is not None
    service.update_session(sid, patch=EdgePatch(drop=((0, 1),),
                                                add=((0, 2, 1.0),)))
    # the old baseline measured a different structure — it must be gone
    assert sess.cold_iterations is None
    led = service.ledger("t")
    service.solve(sid)                           # warm, but baseline-less
    assert led.iterations_cold_ref == 0          # nothing mixed into the ratio
    assert led.iterations_saved == 0
    cold = service.solve(sid, cold=True)         # re-establishes the baseline
    assert sess.cold_iterations == cold.iterations
    service.solve(sid)
    assert led.iterations_cold_ref == cold.iterations
    # a lambda retarget is a different problem too
    service.update_session(sid, lam=1e-2)
    assert sess.cold_iterations is None
    # data-only deltas keep the baseline (same structure, same lambda)
    service.solve(sid, cold=True)
    service.update_session(sid, delta=DataDelta(
        nodes=(0,), y=np.zeros((1,) + tuple(sess.problem.data.y.shape[1:]),
                               np.float32)))
    assert sess.cold_iterations is not None


# ---------------------------------------------------------------------------
# Plan-cache compile accounting
# ---------------------------------------------------------------------------

def test_plan_cache_failing_build_does_not_mark_compiled():
    cache = PlanCache(max_entries=4)
    key = PlanKey(structure_hash="abc", loss="L", regularizer="R",
                  backend="dense", shape_sig=(4, 3, 2, 1, 2))

    def boom():
        raise RuntimeError("planner exploded")

    with pytest.raises(RuntimeError, match="planner exploded"):
        cache.get_or_build(key, boom)
    assert key not in cache
    # the failed build must not have recorded its signature — the retry
    # below really pays the first solve and must report it
    plan, hit, compiled = cache.get_or_build(key, lambda: Plan(key=key))
    assert not hit and compiled


def test_plan_cache_compiled_sigs_bounded():
    cache = PlanCache(max_entries=2)
    assert cache.compiled_sigs_max == 64
    for i in range(3 * cache.compiled_sigs_max):
        assert cache.mark_compiled(("sig", i))
    assert len(cache._compiled_sigs) == cache.compiled_sigs_max
    # LRU: the most recent sig survived, the oldest was forgotten
    assert not cache.mark_compiled(("sig", 3 * cache.compiled_sigs_max - 1))
    assert cache.mark_compiled(("sig", 0))


# ---------------------------------------------------------------------------
# solve_path ledger exactness
# ---------------------------------------------------------------------------

def test_solve_path_ledger_exactness():
    from repro_torch.engine import capped
    cfg = CFG.replace(warm_iters=200, final_iters=100)
    service = SolveService(config=cfg)
    sid = service.create_session("t", _chain_problem())
    lams = [1e-2, 3e-2, 5e-2]
    r1 = service.solve_path(sid, lams)
    r2 = service.solve_path(sid, lams)
    led = service.ledger("t")
    finals = capped(100, cfg.metric_every)
    warm = capped(200, cfg.metric_every)
    assert led.requests == 3                     # create + 2 sweeps
    assert led.solves == 6 and led.path_points == 6
    # one plan lookup per *sweep*, not one per path point
    assert led.cache_misses == 1 and led.cache_hits == 1
    assert led.compiles == 1
    # the shared warm pre-solve is counted once per sweep
    assert led.iterations == 2 * (warm + 3 * finals)
    # response attribution matches: the sweep's single compile rides the
    # first point; every point shares the sweep's cache outcome
    assert [r.compiled for r in r1] == [True, False, False]
    assert [r.cache_hit for r in r1] == [False, False, False]
    assert [r.compiled for r in r2] == [False, False, False]
    assert [r.cache_hit for r in r2] == [True, True, True]


# ---------------------------------------------------------------------------
# Plan persistence: save / load across service processes
# ---------------------------------------------------------------------------

def test_service_plan_persistence_roundtrip(tmp_path):
    svc = SolveService(config=CFG)
    sid = svc.create_session("t", _chain_problem())
    first = svc.solve(sid)
    assert svc.save_plans(str(tmp_path / "plans"))["plans"] == 1

    svc2 = SolveService(config=CFG)                # "restarted" process
    assert svc2.load_plans(str(tmp_path / "plans"),
                           device="cpu")["plans"] == 1
    sid2 = svc2.create_session("t", _chain_problem())
    resp = svc2.solve(sid2)
    # restored plan: zero re-plans (a cache hit); the signature is new
    # to this cache, so the first solve reports its one-time cost
    assert resp.cache_hit and resp.compiled
    assert svc2.plans.misses == 0 and svc2.plans.hits == 1
    assert svc2.plans.loaded == 1
    np.testing.assert_allclose(resp.w.numpy(), first.w.numpy(), rtol=0,
                               atol=1e-6)


def _sbm_plan(cache_cls, plan_cls, key_cls, graph_mod):
    """The reference test's planned SBM graph as a one-plan cache of the
    package whose classes are given."""
    rng = np.random.default_rng(0)
    kw = {"device": "cpu"} if graph_mod.__name__.startswith(
        "repro_torch") else {}
    g, _ = graph_mod.sbm_graph(rng, (8, 8), p_in=0.6, p_out=0.1, **kw)
    layout = graph_mod.plan_edge_blocks(g)
    key = key_cls(structure_hash=g.structure_hash(), loss="SquaredLoss()",
                  regularizer="TotalVariation()", backend="pallas",
                  shape_sig=(g.num_nodes, g.num_edges, 4, 2, g.max_degree))
    cache = cache_cls()
    cache.get_or_build(key, lambda: plan_cls(key=key, layout=layout))
    return g, layout, key, cache


def test_plan_cache_persistence_validates(tmp_path):
    from repro_torch.core import graph as graph_mod

    g, layout, key, cache = _sbm_plan(PlanCache, Plan, PlanKey, graph_mod)
    path = str(tmp_path / "plans")
    cache.save(path)

    fresh = PlanCache()
    assert fresh.load(path, device="cpu")["plans"] == 1
    restored = fresh._plans[key].layout
    for field in ("node_perm", "src", "dst", "edge_pos", "edge_flip",
                  "in_ptr", "in_ids", "out_run"):
        assert torch.equal(getattr(restored, field), getattr(layout, field))
    # the deserialized layout reproduces the original structure hash
    assert layout_structure_hash(restored) == g.structure_hash()

    # a checkpoint claiming a different structure must be refused
    meta_path = tmp_path / "plans" / "plans.json"
    meta = json.loads(meta_path.read_text())
    meta["plans"][0]["key"]["structure_hash"] = "0" * 32
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="stale"):
        PlanCache().load(path, device="cpu")

    # ... and a tampered payload reads as corruption
    meta["plans"][0]["key"]["structure_hash"] = key.structure_hash
    meta["plans"][0]["layout"]["payload_hash"] = "f" * 32
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="corrupt"):
        PlanCache().load(path, device="cpu")


# ---------------------------------------------------------------------------
# Against the reference: the same inputs through repro.serving
# ---------------------------------------------------------------------------

def _request_sequence(pkg, service, problems, arrays):
    """One fixed request sequence on a service of ``pkg``'s serving
    layer: two tenants on one structure (cold, then a plan hit), a data
    delta and a warm solve, a lambda retarget, an edge patch, a forced
    cold solve and a path sweep.  Returns the responses."""
    DataDelta_, EdgePatch_ = pkg.DataDelta, pkg.EdgePatch
    a = service.create_session("a", problems[0])
    b = service.create_session("b", problems[1])
    out = [service.solve(a), service.solve(b)]
    y = arrays[1]
    service.update_session(a, delta=DataDelta_(
        nodes=(3, 17), y=y[[3, 17]] + np.float32(0.05)))
    out.append(service.solve(a))
    service.update_session(a, lam=2e-2)
    out.append(service.solve(a))
    service.update_session(b, patch=EdgePatch_(drop=((10, 11),),
                                               add=((5, 30, 1.0),)))
    out.append(service.solve(b))
    out.append(service.solve(b, cold=True))
    out.extend(service.solve_path(a, [1e-2, 5e-2]))
    service.close(b)
    return out


@pytest.mark.parametrize("engine", ["dense", "pallas_fused"])
def test_request_sequence_matches_reference(engine):
    """The same request sequence through both packages: every response's
    ``w`` within 1e-4 of the reference's, iterations, SLA outcome, cache
    hit and compile flags equal; ledger summaries and plan-cache counts
    equal."""
    import repro.serving as jserving
    import repro_torch.serving as tserving

    cfg = CFG.replace(warm_iters=200, final_iters=100)
    if engine == "pallas_fused":
        cfg = cfg.replace(backend="pallas", fused=True)
    arrays = _chain_arrays()
    want = _request_sequence(
        jserving, jserving.SolveService(config=_j_config(cfg)),
        [_j_chain_problem(seed=0), _j_chain_problem(seed=1)], arrays)
    got_svc = SolveService(config=cfg)
    got = _request_sequence(tserving, got_svc,
                            [_chain_problem(seed=0), _chain_problem(seed=1)],
                            arrays)
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        for name in ("iterations", "warm", "cache_hit", "compiled",
                     "meets_sla", "batch_width", "queue_wait"):
            assert getattr(g, name) == getattr(w, name), (i, name)
        np.testing.assert_allclose(g.w.numpy(), np.asarray(w.w), rtol=0,
                                   atol=1e-4, err_msg=str(i))
        assert g.lam == pytest.approx(w.lam, rel=1e-6)
        assert set(g.certificate) == set(w.certificate)
    summary = got_svc.summary()
    jsvc_summary = _sequence_summary(jserving, cfg, arrays)
    assert summary == jsvc_summary


def _sequence_summary(jserving, cfg, arrays):
    svc = jserving.SolveService(config=_j_config(cfg))
    _request_sequence(jserving, svc,
                      [_j_chain_problem(seed=0), _j_chain_problem(seed=1)],
                      arrays)
    return svc.summary()


def _random_graph(seed: int, v: int, edges: int):
    rng = np.random.default_rng(seed)
    pairs = rng.choice(v, size=(edges, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return pairs, rng.uniform(0.5, 2.0, len(pairs)).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layout_structure_hash_matches_reference(seed):
    """On the same graph the port's layout (bit-equal to the
    reference's) hashes to the reference's layout hash and to both
    graphs' structure hash."""
    from repro.core.graph import build_graph as j_build
    from repro.core.graph import plan_edge_blocks as j_plan
    from repro.serving import layout_structure_hash as j_hash
    from repro_torch.core.graph import plan_edge_blocks

    pairs, wts = _random_graph(seed, 600, 2400)
    g = build_graph(pairs, wts, 600, device="cpu")
    jg = j_build(pairs, wts, 600)
    for bv in (None, 256):
        got = layout_structure_hash(plan_edge_blocks(g, block_nodes=bv))
        want = j_hash(j_plan(jg, block_nodes=bv))
        assert got == want == g.structure_hash() == jg.structure_hash()


def test_transfer_edge_duals_bit_equal_to_reference():
    """Random patches (drops, adds, flipped orientations): the port's
    dual transfer equals the reference's bit for bit."""
    import jax.numpy as jnp
    from repro.core.graph import build_graph as j_build
    from repro.core.partition import transfer_edge_duals as j_transfer

    rng = np.random.default_rng(3)
    for seed in range(4):
        pairs, wts = _random_graph(seed, 50, 120)
        old = build_graph(pairs, wts, 50, device="cpu")
        keep = rng.random(len(pairs)) > 0.3
        new_pairs = np.concatenate([pairs[keep][:, ::-1],
                                    rng.choice(50, size=(20, 2))])
        new_pairs = new_pairs[new_pairs[:, 0] != new_pairs[:, 1]]
        new = build_graph(new_pairs, np.ones(len(new_pairs), np.float32),
                          50, device="cpu")
        flipped = dataclasses.replace(new, src=new.dst, dst=new.src)
        u = rng.standard_normal((old.num_edges, 3)).astype(np.float32)
        j_old = j_build(pairs, wts, 50)
        j_new = j_build(new_pairs, np.ones(len(new_pairs), np.float32), 50)
        j_flipped = dataclasses.replace(j_new, src=j_new.dst,
                                        dst=j_new.src)
        for t_new, jt_new in ((new, j_new), (flipped, j_flipped)):
            got = transfer_edge_duals(old, t_new, torch.from_numpy(u))
            want = j_transfer(j_old, jt_new, jnp.asarray(u))
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("direction", ["reference_saves", "port_saves"])
def test_plan_files_cross_packages(tmp_path, direction):
    """A plan file saved by either package loads in the other: the
    restored layout's arrays and statics equal the saver's, its
    structure hash recomputes to the key's, the RCM orders are
    reinstalled, and a service restored from the file answers as a
    cache hit without re-planning."""
    import repro.serving as jserving
    from repro.core import graph as j_graph_mod
    from repro.core import partition as j_partition
    from repro_torch.core import graph as graph_mod
    from repro_torch.core import partition

    path = str(tmp_path / "plans")
    fields = ("node_perm", "node_inv", "src", "dst", "weights", "inc_edges",
              "inc_signs", "edge_pos", "edge_flip")
    statics = ("block_nodes", "num_blocks", "block_edges", "kn", "klo",
               "khi", "max_degree", "num_nodes", "num_edges")
    if direction == "reference_saves":
        g, layout, key, cache = _sbm_plan(
            jserving.PlanCache, jserving.Plan, jserving.PlanKey, j_graph_mod)
        cache.save(path)
        loaded = PlanCache()
        counts = loaded.load(path, device="cpu")
        tkey = PlanKey(**dataclasses.asdict(key))
        restored = loaded._plans[tkey].layout
        assert restored.in_ptr is not None      # compact incidence rebuilt
        memo = partition.export_rcm_orders({key.structure_hash})
    else:
        g, layout, key, cache = _sbm_plan(PlanCache, Plan, PlanKey,
                                          graph_mod)
        cache.save(path)
        loaded = jserving.PlanCache()
        counts = loaded.load(path)
        tkey = jserving.PlanKey(**dataclasses.asdict(key))
        restored = loaded._plans[tkey].layout
        memo = j_partition.export_rcm_orders({key.structure_hash})
    assert counts == {"plans": 1, "rcm_orders": 1}
    for f in fields:
        np.testing.assert_array_equal(np.asarray(getattr(restored, f)),
                                      np.asarray(getattr(layout, f)))
    for f in statics:
        assert getattr(restored, f) == getattr(layout, f)
    want_hash = layout_structure_hash(layout) if direction == "port_saves" \
        else jserving.layout_structure_hash(layout)
    assert jserving.layout_structure_hash(restored) == want_hash \
        == key.structure_hash
    assert len(memo) == 1


@pytest.mark.parametrize("direction", ["reference_saves", "port_saves"])
def test_service_restores_plans_across_packages(tmp_path, direction):
    """A fused ``pallas`` service whose plan file the other package
    wrote: its first answer is a plan-cache hit (no planning) that
    reports the signature's first solve, and equals a service that
    planned itself."""
    import repro.serving as jserving

    cfg = CFG.replace(backend="pallas", fused=True)
    path = str(tmp_path / "plans")
    if direction == "reference_saves":
        svc = jserving.SolveService(config=_j_config(cfg))
        svc.solve(svc.create_session("t", _j_chain_problem()))
    else:
        svc = SolveService(config=cfg)
        svc.solve(svc.create_session("t", _chain_problem()))
    assert svc.save_plans(path) == {"plans": 1, "rcm_orders": 1}
    restored = SolveService(config=cfg)
    restored.load_plans(path, device="cpu")
    resp = restored.solve(restored.create_session("t", _chain_problem()))
    assert resp.cache_hit and resp.compiled and restored.plans.misses == 0
    planned = SolveService(config=cfg)
    own = planned.solve(planned.create_session("t", _chain_problem()))
    assert torch.equal(resp.w, own.w)
    assert resp.iterations == own.iterations
    if direction == "port_saves":
        jsvc = jserving.SolveService(config=_j_config(cfg))
        jsvc.load_plans(path)
        jresp = jsvc.solve(jsvc.create_session("t", _j_chain_problem()))
        assert jresp.cache_hit and jsvc.plans.misses == 0
        assert jresp.iterations == resp.iterations
        np.testing.assert_allclose(np.asarray(jresp.w), resp.w.numpy(),
                                   rtol=0, atol=1e-4)


def test_synthetic_stream_matches_reference():
    """One seed, one stream: the same drift rows and edge churn in both
    packages."""
    from repro.serving import synthetic_stream as j_stream

    problem, jp = _chain_problem(), _j_chain_problem()
    got = synthetic_stream(np.random.default_rng(7), problem.data,
                           problem.graph, num_steps=5, drift_fraction=0.1,
                           drift_scale=0.05, churn_every=2)
    want = j_stream(np.random.default_rng(7), jp.data, jp.graph,
                    num_steps=5, drift_fraction=0.1, drift_scale=0.05,
                    churn_every=2)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.step == w.step
        assert (g.patch is None) == (w.patch is None)
        if g.patch is not None:
            assert (g.patch.add, g.patch.drop) == (w.patch.add, w.patch.drop)
        assert g.delta.nodes == w.delta.nodes
        np.testing.assert_array_equal(g.delta.y, w.delta.y)


# metrics whose values are host timings (the rest must match exactly)
_TIMED = ("repro_serving_request_seconds", "repro_serving_execute_seconds",
          "repro_serving_compile_seconds_total", "repro_span_seconds")


def _untimed_samples(text: str) -> list:
    return sorted(line for line in text.splitlines()
                  if line and not line.startswith("#")
                  and not line.startswith(_TIMED))


def test_telemetry_export_matches_reference():
    """The fixed request sequence with telemetry on in both packages:
    the Prometheus exports name the same metrics with the same labels,
    and every sample that is not a host timing has the same value."""
    import repro.serving as jserving
    from repro import obs as jobs
    from repro_torch import obs
    import repro_torch.serving as tserving

    cfg = CFG.replace(warm_iters=200, final_iters=100)
    arrays = _chain_arrays()
    texts = []
    for o, run in (
            (jobs, lambda: _request_sequence(
                jserving, jserving.SolveService(config=_j_config(cfg)),
                [_j_chain_problem(seed=0), _j_chain_problem(seed=1)],
                arrays)),
            (obs, lambda: _request_sequence(
                tserving, SolveService(config=cfg),
                [_chain_problem(seed=0), _chain_problem(seed=1)],
                arrays))):
        o.disable()
        o.reset()
        o.enable()
        try:
            run()
            texts.append(o.export.prometheus_text())
        finally:
            o.disable()
            o.reset()
    want, got = texts

    def names(text):
        # a compile's seconds are counted only when the re-run was the
        # faster: host timing decides whether that counter exists
        return {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE")} - {_TIMED[2]}

    assert names(got) == names(want)
    assert "repro_serving_requests_total" in names(got)
    assert _untimed_samples(got) == _untimed_samples(want)

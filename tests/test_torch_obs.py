"""repro_torch.obs: the reference's telemetry, free while off, on the CPU.

Ports of ``tests/test_obs.py``'s primitive, transfer, ledger and
validator tests on the port's objects (the serving tests wait for the
serving layer, ROADMAP.md §1 item 12), and:

  * the same recorded operations — metric mutations with labels and
    buckets, a federated run's ledger export, a tol solve's transfer and
    solve counters — give the reference's ``export_json`` snapshot and
    Prometheus text, character for character;
  * while telemetry is off and no profiler runs, ``obs.profile.annotate``
    enters no ``record_function`` range (a range costs host time on
    every call, where the reference's ``jax.named_scope`` costs nothing
    at run time), and a tol solve still makes exactly one
    ``device_fetch`` and no other host read;
  * ``obs.profile.trace`` of a dense solve writes a Chrome trace that
    names the Algorithm 1 phases.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs                                  # noqa: E402
from repro_torch import obs                                    # noqa: E402
from repro_torch.api import Solver, SolverConfig               # noqa: E402
from repro_torch.engine import loop                            # noqa: E402
from repro_torch.federated import (CommLedger,                 # noqa: E402
                                   FederatedConfig, run_federated)
from repro_torch.obs import events as obs_events               # noqa: E402
from repro_torch.obs import export as obs_export               # noqa: E402
from repro_torch.scenarios import get_scenario                 # noqa: E402

from test_torch_device_stop import no_host_reads               # noqa: E402

# the reference's tol setting (tests/test_device_stop.py): these solves
# stop at 660, and the tol engines run no block after the stop
TOL_CONF = dict(num_iters=4000, rho=1.9, metric_every=10, tol=5e-3,
                compute_diagnostics=False)
PHASES = ("alg1_gather_duals", "alg1_primal_prox", "alg1_edge_diff",
          "alg1_dual_prox", "alg1_km_relaxation")


@pytest.fixture
def fresh_obs():
    """Telemetry off, registry and event log empty, in both packages;
    restored after."""
    for o in (obs, jobs):
        o.disable()
        o.reset()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset()


@pytest.fixture
def obs_on(fresh_obs):
    obs.enable()
    yield
    obs.disable()


def _scenario_problem():
    return get_scenario("sbm_regression").build(
        seed=0, smoke=True, lam=1e-2, device="cpu").problem


# ---------------------------------------------------------------------------
# telemetry primitives
# ---------------------------------------------------------------------------

def test_disabled_is_noop(fresh_obs):
    c = obs.counter("t_total")
    g = obs.gauge("t_gauge")
    h = obs.histogram("t_seconds")
    c.inc()
    g.set(5.0)
    h.observe(0.1)
    assert c.value == 0.0 and g.value == 0.0 and h.count == 0
    assert obs.span("anything") is obs.NULL_SPAN
    with obs.span("anything"):
        pass
    assert obs.REGISTRY.find("repro_span_seconds") == []


def test_metrics_record_when_enabled(obs_on):
    c = obs.counter("t_total", help="h")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    obs.gauge("t_gauge").set(-1.0)
    assert obs.gauge("t_gauge").value == -1.0
    h = obs.histogram("t_seconds")
    for v in (0.001, 0.002, 0.004, 0.3):
        h.observe(v)
    assert h.count == 4
    assert 0.001 <= h.percentile(0.5) <= 0.004
    assert h.percentile(0.99) <= 30.0
    obs.counter("t_lab", tenant="a").inc()
    obs.counter("t_lab", tenant="b").inc(2)
    assert {m.value for m in obs.REGISTRY.find("t_lab")} == {1.0, 2.0}


def test_span_records_duration(obs_on):
    with obs.span("phase_x"):
        pass
    (h,) = obs.REGISTRY.find("repro_span_seconds")
    assert h.count == 1 and dict(h.labels)["span"] == "phase_x"


def test_registry_rejects_kind_conflicts(obs_on):
    obs.counter("t_conflict")
    with pytest.raises(TypeError):
        obs.gauge("t_conflict")


# ---------------------------------------------------------------------------
# the transfer counter: one fetch per tol solve, off and on
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["dense", "fused"])
def test_tol_solve_one_transfer_obs_off(fresh_obs, monkeypatch, path):
    """Telemetry disabled changes nothing: a tol solve is exactly one
    ``device_fetch`` and no other host read, and the counter stays
    unregistered."""
    problem = _scenario_problem()
    cfg = SolverConfig(**TOL_CONF, backend="pallas", fused=path == "fused")
    Solver(cfg).run(problem)               # plans and caches the layout
    before = loop.device_fetch.calls
    with no_host_reads(monkeypatch):
        result = Solver(cfg).run(problem)
    assert result.diagnostics["iterations"] == 660
    assert loop.device_fetch.calls == before + 1
    assert obs.REGISTRY.find("repro_transfers_device_to_host_total") == []
    assert obs.REGISTRY.find("repro_solves_total") == []


@pytest.mark.parametrize("path", ["dense", "fused"])
def test_tol_solve_counts_one_transfer_obs_on(obs_on, monkeypatch, path):
    """With telemetry on, the library-level counter sees the same single
    fetch the call count sees — no extra transfers because observability
    was enabled."""
    problem = _scenario_problem()
    cfg = SolverConfig(**TOL_CONF, backend="pallas", fused=path == "fused")
    Solver(cfg).run(problem)
    before = obs.counter("repro_transfers_device_to_host_total").value
    calls = loop.device_fetch.calls
    with no_host_reads(monkeypatch):
        Solver(cfg).run(problem)
    after = obs.counter("repro_transfers_device_to_host_total").value
    assert loop.device_fetch.calls == calls + 1
    assert after - before == 1.0
    (solves,) = obs.REGISTRY.find("repro_solves_total")
    assert solves.value == 2.0 and dict(solves.labels) == {
        "backend": "pallas"}
    (span,) = obs.REGISTRY.find("repro_span_seconds")
    assert span.count == 2 and dict(span.labels)["span"] == "solver_run"


# ---------------------------------------------------------------------------
# the same records in both packages give the same exports
# ---------------------------------------------------------------------------

def _record(o, fed, solve):
    """One script of metric operations, run against package ``o`` with
    its federated runtime ``fed`` and a tol solve ``solve()``."""
    o.counter("t_total", help="a counter").inc(3)
    o.counter("t_lab", help="labeled", tenant="a").inc()
    o.counter("t_lab", help="labeled", tenant="b").inc(2.5)
    o.gauge("t_gauge", help="a gauge").set(-1.25)
    h = o.histogram("t_seconds", help="a histogram")
    for v in (1e-5, 0.001, 0.002, 0.004, 0.3, 100.0):
        h.observe(v)
    c = o.histogram("t_width", buckets=o.COUNT_BUCKETS, tenant="x")
    for v in (1, 3, 3, 70):
        c.observe(v)
    fed()
    solve()


def test_same_records_give_reference_exports(fresh_obs):
    """Metric mutations, a federated run's ledger (bernoulli + int8 on
    grid2d: counters and gauges from its meters) and a dense tol solve
    (solve counter and transfer counter), recorded in both packages:
    equal JSON snapshots and Prometheus text.  The ``solver_run`` span
    is host wall time, so it is left out here (counted above)."""
    from repro.api import Solver as JSolver
    from repro.api import SolverConfig as JConfig
    from repro.federated import FederatedConfig as JFedConfig
    from repro.federated import run_federated as j_run
    from repro.scenarios import get_scenario as j_get

    fconf = dict(num_rounds=20, participation="bernoulli",
                 compression="int8", seed=3)
    inst = get_scenario("grid2d").build(seed=0, smoke=True, device="cpu")
    jinst = j_get("grid2d").build(seed=0, smoke=True)
    jprob = j_get("sbm_regression").build(seed=0, smoke=True,
                                          lam=1e-2).problem
    for o in (obs, jobs):
        o.enable()
    _record(obs, lambda: run_federated(inst.problem,
                                       FederatedConfig(**fconf)),
            lambda: Solver(SolverConfig(**TOL_CONF)).run(_scenario_problem()))
    _record(jobs, lambda: j_run(jinst.problem, JFedConfig(**fconf)),
            lambda: JSolver(JConfig(**TOL_CONF)).run(jprob))
    for o in (obs, jobs):
        for m in o.REGISTRY.find("repro_span_seconds"):
            del o.REGISTRY._metrics[(m.name, m.labels)]
    got, want = obs_export.export_json(), jobs.export.export_json()
    assert json.loads(got)["metrics"], got
    assert got == want
    assert obs_export.prometheus_text() == jobs.export.prometheus_text()
    obs_export.validate_prometheus(obs_export.prometheus_text())
    names = {m["name"] for m in json.loads(got)["metrics"]}
    assert {"repro_federated_up_bytes_total", "repro_solves_total",
            "repro_transfers_device_to_host_total"} <= names


# ---------------------------------------------------------------------------
# device-profile ranges: none while off, the paper phases in a trace
# ---------------------------------------------------------------------------

def test_annotate_enters_no_range_while_off(fresh_obs, monkeypatch):
    """Telemetry off and no profiler: ``annotate`` hands back the shared
    no-op context and a dense solve (every step phase) and a federated
    run (its mailbox exchange) enter no ``record_function``.  On, they
    do."""
    entered = []
    real = torch.profiler.record_function

    def counted(name, *a, **kw):
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    problem = _scenario_problem()
    cfg = SolverConfig(num_iters=20, rho=1.9, metric_every=10)
    assert obs.profile.annotate(obs.profile.PHASE_GATHER) is obs.NULL_SPAN
    Solver(cfg).run(problem)
    run_federated(problem, FederatedConfig(num_rounds=4))
    assert entered == []
    obs.enable()
    Solver(cfg).run(problem)
    run_federated(problem, FederatedConfig(num_rounds=4))
    assert set(PHASES) | {"solve_metrics",
                          "mailbox_exchange_diff"} <= set(entered)
    assert entered.count("alg1_gather_duals") == 20 + 4


def test_trace_names_the_phases(fresh_obs, tmp_path):
    """A trace of a dense solve (telemetry off: the profiler alone turns
    the ranges on) holds one range per phase and step."""
    problem = _scenario_problem()
    cfg = SolverConfig(num_iters=6, rho=1.9, metric_every=3)
    logdir = str(tmp_path / "trace")
    with obs.profile.trace(logdir) as d:
        Solver(cfg).run(problem)
    assert d == logdir
    with open(f"{logdir}/trace.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    for phase in PHASES:
        assert names.count(phase) == 6, phase
    assert names.count("solve_metrics") == 2
    # outside the trace the ranges are off again
    assert obs.profile.annotate(PHASES[0]) is obs.NULL_SPAN


# ---------------------------------------------------------------------------
# ledger gauges: finite on empty
# ---------------------------------------------------------------------------

def test_empty_ledgers_export_finite_gauges(obs_on):
    CommLedger.empty().export_obs()
    snap = json.loads(obs_export.export_json())  # allow_nan=False
    by_name = {m["name"]: m for m in snap["metrics"]
               if m["kind"] == "gauge"}
    assert by_name["repro_federated_bytes_per_round"]["value"] == 0.0
    assert by_name["repro_federated_cumulative_bytes"]["value"] == 0.0
    obs_export.validate_prometheus(obs_export.prometheus_text())


def test_cumulative_bytes_empty_is_empty_not_nan():
    cum = CommLedger.empty().cumulative_bytes()
    assert cum.size == 0


def test_ledger_cumulative_bytes():
    """Per-round bytes add up, in float64 on the host, to the total."""
    led = CommLedger(*(torch.tensor(v, dtype=torch.float32) for v in (
        [1.0, 2.0], [6.0, 12.0], [3.0, 0.0], [24.0, 0.0])))
    np.testing.assert_array_equal(led.cumulative_bytes(), [30.0, 42.0])
    assert led.total_bytes == 42.0 and led.summary()["rounds"] == 2.0


# ---------------------------------------------------------------------------
# export validators reject bad payloads
# ---------------------------------------------------------------------------

def test_prometheus_validator_rejects_nan():
    bad = "# TYPE x gauge\nx nan\n"
    with pytest.raises(ValueError, match="non-finite"):
        obs_export.validate_prometheus(bad)


def test_prometheus_validator_rejects_sample_less_type():
    with pytest.raises(ValueError, match="no samples"):
        obs_export.validate_prometheus("# TYPE x counter\n")


def test_validate_event_rejects_missing_and_nonfinite():
    good = {"seq": 0, "event": "solve", "tenant": "t", "session": "s",
            "queue_wait": 0, "batch_width": 1, "warm": False,
            "cache_hit": True, "compiled": False, "iterations": 10,
            "residual": 1e-4, "meets_sla": True, "seconds": 0.1,
            "solve_seconds": 0.1, "compile_seconds": 0.0, "lam": 0.01,
            "tol": 1e-3}
    obs_events.validate_event(good)
    with pytest.raises(ValueError, match="missing"):
        obs_events.validate_event({k: v for k, v in good.items()
                                   if k != "residual"})
    with pytest.raises(ValueError, match="not finite"):
        obs_events.validate_event({**good, "seconds": float("nan")})
    with pytest.raises(ValueError, match="kind"):
        obs_events.validate_event({**good, "event": "bogus"})

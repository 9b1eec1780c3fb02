"""The port's experiment harness (``experiments/run_torch.py``) against
the reference's (``experiments/run.py``), on the CPU: ``run_scenario``'s
rows on the same scenario, backends and budget carry the same fields,
their metrics within 1e-4 (the cross-backend tolerance of
``tests/test_conformance.py``), and the same skip records.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
METRICS = ("objective", "weight_mse", "prediction_mse", "accuracy",
           "dual_infeasibility")
SAME = ("scenario", "backend", "lam", "tol", "iterations", "num_nodes",
        "num_edges", "status")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def harnesses():
    return (_load("run_torch_harness", ROOT / "experiments" / "run_torch.py"),
            _load("run_reference_harness", ROOT / "experiments" / "run.py"))


def _rows(harness, name, backends, config_kw, **kw):
    config = harness.SolverConfig(**config_kw)
    return harness.run_scenario(name, backends, seed=0, smoke=True,
                                config=config, **kw)


def _assert_rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in SAME:
            assert g[k] == w[k], (k, g[k], w[k])
        for k in METRICS:
            if w[k] is None:
                assert g[k] is None, k
            else:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                           err_msg=(g["backend"], k))


SMOKE = dict(rho=1.9, warm_iters=300, final_iters=200, num_iters=500)


def test_fields_match_reference(harnesses):
    port, ref = harnesses
    assert port.CSV_FIELDS == ref.CSV_FIELDS
    assert port.METRIC_KEYS == ref.METRIC_KEYS
    assert port.SERVING_CSV_FIELDS == ref.SERVING_CSV_FIELDS
    assert port.FED_CSV_FIELDS == ref.FED_CSV_FIELDS


@pytest.mark.parametrize("backends", [("dense",), ("pallas",)])
def test_sweep_rows_match_reference(harnesses, backends):
    port, ref = harnesses
    got, got_skips = _rows(port, "sbm_regression", list(backends), SMOKE,
                           lams=None, device="cpu")
    want, want_skips = _rows(ref, "sbm_regression", list(backends), SMOKE,
                             lams=None)
    _assert_rows_match(got, want)
    assert got_skips == want_skips == []
    assert set(got[0]) == set(port.CSV_FIELDS)


def test_tol_rows_match_reference(harnesses):
    port, ref = harnesses
    kw = dict(lams=[1e-2], tol=1e-3, tol_every=50)
    got, _ = _rows(port, "sbm_regression", ["dense"], SMOKE, device="cpu",
                   **kw)
    want, _ = _rows(ref, "sbm_regression", ["dense"], SMOKE, **kw)
    _assert_rows_match(got, want)
    assert got[0]["iterations"] == want[0]["iterations"] > 0


def test_skip_records_match_reference(harnesses):
    """``sharded`` x a logistic scenario: both packages run it (both
    sharded backends take every registered loss), so neither records a
    skip; the rows agree."""
    port, ref = harnesses
    short = dict(SMOKE, warm_iters=40, final_iters=40)
    kw = dict(lams=[1e-2])
    got, got_skips = _rows(port, "clustered_logistic", ["sharded"], short,
                           device="cpu", **kw)
    want, want_skips = _rows(ref, "clustered_logistic", ["sharded"], short,
                             **kw)
    assert got_skips == want_skips
    _assert_rows_match(got, want)


def test_skip_records_only_for_not_implemented(harnesses, monkeypatch):
    """A backend's refusal (``NotImplementedError``) becomes a skip
    record; any other error, such as a kernel that fails to build or
    launch, propagates and fails the run."""
    port, _ = harnesses

    def refuse(*a, **k):
        raise NotImplementedError("refused here")

    monkeypatch.setattr(port, "solve_path", refuse)
    rows, skips = _rows(port, "sbm_regression", ["dense"], SMOKE,
                        lams=[1e-2], device="cpu")
    assert rows == [] and skips == [{"scenario": "sbm_regression",
                                     "backend": "dense",
                                     "reason": "refused here"}]

    def fail(*a, **k):
        raise RuntimeError("kernel build failed")

    monkeypatch.setattr(port, "solve_path", fail)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _rows(port, "sbm_regression", ["dense"], SMOKE, lams=[1e-2],
              device="cpu")


def test_federated_rows_match_reference(harnesses):
    """The federated mode's rows: synchronous full participation (the
    dense iteration) and int8 messages, against the reference's."""
    port, ref = harnesses
    rows = {}
    for name, harness in (("port", port), ("ref", ref)):
        parts = [harness._parse_policy("full", "participation")]
        comps = [harness._parse_policy(t, "compression")
                 for t in ("none", "int8")]
        kw = dict(device="cpu") if name == "port" else {}
        rows[name] = harness.run_federated_scenario(
            "sbm_regression", parts, comps, seed=0, smoke=True, rounds=60,
            local_steps=1, **kw)
    for g, w in zip(rows["port"], rows["ref"], strict=True):
        assert set(g) == set(w)
        for k in ("participation", "compression", "rounds", "total_bytes",
                  "up_bytes", "down_bytes", "bytes_per_round"):
            assert g[k] == w[k], k
        for k in ("objective", "weight_mse", "prediction_mse"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def test_serving_rows(harnesses):
    """The serving mode's stream row: every warm answer certifies, in
    fewer iterations than cold, with the reference's CSV fields."""
    port, _ = harnesses
    (row,) = port.run_serving_scenario("sbm_regression", [0.05], seed=0,
                                       smoke=True, steps=1, churn_every=0,
                                       device="cpu")
    assert set(row) <= set(port.SERVING_CSV_FIELDS)
    assert row["status"] == "ok" and row["sla_met_fraction"] == 1.0
    assert 0 < row["warm_cold_iter_ratio"] < 1

"""The port's serving and telemetry examples and the experiment
harness's CLI, each on the CPU in its own process, and the device rule
for every entry point of ``examples/*_torch.py`` and
``experiments/run_torch.py``: with no ``--device`` they run on the CUDA
card, and raise where there is none (never a quiet move to the CPU).
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from test_torch_examples import TIMEOUT, run_example          # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ENTRY_POINTS = sorted(p.relative_to(ROOT).as_posix() for p in
                      (ROOT / "examples").glob("*_torch.py")) + [
    "experiments/run_torch.py"]


def test_serving_stream():
    out = run_example("serving_stream_torch.py")
    assert "meets_sla=True" in out
    assert "cache_hit=True, compiled=False (plan shared" in out
    assert "1 flush served 4 requests as one batched solve " \
           "(certified=True)" in out
    assert "cache_hit=True with 0 re-plans" in out


def test_observability_tour(tmp_path):
    out = run_example("observability_tour_torch.py", "--out",
                      str(tmp_path), "--profile",
                      env={"REPRO_SOLVER_MAX_ITERS": "4000"})
    assert "validated" in out and "metric series" in out
    for f in ("events.jsonl", "metrics.json", "metrics.prom"):
        assert (tmp_path / f).stat().st_size > 0, f
    names = {m["name"] for m in json.loads(
        (tmp_path / "metrics.json").read_text())["metrics"]}
    assert "repro_transfers_device_to_host_total" in names
    assert "repro_federated_up_bytes_total" in names
    trace = (tmp_path / "profile" / "trace.json").read_text()
    assert "alg1_primal_prox" in trace


def test_experiment_harness_cli(tmp_path):
    """The sweep mode writes the reference's report files and CSV
    fields."""
    run_torch = _load("experiments/run_torch.py")
    proc = subprocess.run(
        [sys.executable, "experiments/run_torch.py", "--smoke", "--device",
         "cpu", "--scenarios", "sbm_regression", "--backends",
         "dense,pallas", "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=TIMEOUT,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    report = json.loads((tmp_path / "report.json").read_text())
    assert {r["backend"] for r in report["rows"]} == {"dense", "pallas"}
    assert report["skipped"] == []
    header = (tmp_path / "report.csv").read_text().splitlines()[0]
    assert header.split(",") == list(run_torch.CSV_FIELDS)


def _load(entry: str):
    spec = importlib.util.spec_from_file_location(
        "entry_" + Path(entry).stem, ROOT / entry)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_defaults_to_cuda_and_raises_without_it(entry,
                                                            tmp_path,
                                                            monkeypatch):
    """No ``--device``: the card, and without one the port's
    ``RuntimeError`` before any work (no report written).  In this
    process with CUDA hidden, but for the telemetry tour, which switches
    telemetry on first: in its own process (``CUDA_VISIBLE_DEVICES=``)."""
    args = {"experiments/run_torch.py": ["--smoke", "--scenarios",
                                         "sbm_regression", "--backends",
                                         "dense", "--out", str(tmp_path)],
            "examples/observability_tour_torch.py": ["--out",
                                                     str(tmp_path)],
            "examples/distributed_nlasso_torch.py": ["--ranks", "2"]
            }.get(entry, [])
    if entry == "examples/observability_tour_torch.py":
        proc = subprocess.run(
            [sys.executable, entry, *args], cwd=ROOT, capture_output=True,
            text=True, timeout=TIMEOUT,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0, proc.stdout[-2000:]
        assert "RuntimeError: repro_torch runs on a CUDA device by " \
            "default" in proc.stderr, proc.stderr[-4000:]
    else:
        monkeypatch.setenv("REPRO_SMOKE", "1")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        main = _load(entry).main
        with pytest.raises(RuntimeError,
                           match="runs on a CUDA device by default"):
            main(args)
    assert not list(tmp_path.glob("*.csv")), "a report was written"

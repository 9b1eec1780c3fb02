"""The port's examples (``examples/*_torch.py``) run end to end on the
CPU, each in its own process at its smoke size with ``--device cpu``,
and make their claims:

  * ``quickstart_torch.py``: the learned cluster means within 0.25 of
    the truth, the nLasso test MSE below both pooled baselines',
  * ``scenario_tour_torch.py``: every registered scenario built and
    solved,
  * ``federated_round_trip_torch.py``: synchronous mode equals the dense
    backend, a checkpointed resume is bitwise the straight run,
  * ``distributed_nlasso_torch.py``: a gloo world of two processes,
    every sharded run against the dense one.

``tests/test_torch_examples_serving.py`` runs the other two and the
experiment harness, and holds every entry point to the device rule.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240            # seconds a process may take (alone: 4-16 s)


def run_example(name: str, *args: str, env: dict | None = None) -> str:
    """Run ``examples/<name>`` with ``--device cpu`` at its smoke size;
    return its standard output (fails on a non-zero exit)."""
    full_env = {**os.environ, "REPRO_SMOKE": "1", "OMP_NUM_THREADS": "2",
                **(env or {})}
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / name), "--device", "cpu",
         *args], cwd=ROOT, env=full_env, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-4000:])
    return proc.stdout


def _float(pattern: str, text: str) -> float:
    m = re.search(pattern, text)
    assert m, (pattern, text[-2000:])
    return float(m.group(1))


def test_quickstart():
    out = run_example("quickstart_torch.py")
    truth = {0: (2.0, 2.0), 1: (-2.0, 2.0)}
    for c, (t0, t1) in truth.items():
        m = re.search(rf"cluster {c}: learned mean w = \(([-+.\d]+), "
                      rf"([-+.\d]+)\)", out)
        assert m, out
        assert abs(float(m.group(1)) - t0) <= 0.25, out
        assert abs(float(m.group(2)) - t1) <= 0.25, out
    ours = _float(r"nLasso: ([-+.\de]+)", out)
    pooled = _float(r"pooled linear regression: ([-+.\de]+)", out)
    tree = _float(r"decision tree: ([-+.\de]+)", out)
    assert ours < pooled and ours < tree, (ours, pooled, tree)
    assert _float(r"eq\. 24\): ([-+.\de]+)", out) < 5e-2


def test_scenario_tour():
    from repro_torch.scenarios import SCENARIOS

    out = run_example("scenario_tour_torch.py")
    assert f"{len(SCENARIOS)} registered scenarios (smoke instances)" in out
    for name in SCENARIOS:
        assert f"== {name} ==" in out, name
    solved = [line for line in out.splitlines()
              if line.strip().startswith("solved:")]
    assert len(solved) == len(SCENARIOS)
    assert "nan" not in " ".join(solved)
    assert "experiments/run_torch.py --smoke" in out


def test_federated_round_trip():
    out = run_example("federated_round_trip_torch.py")
    assert _float(r"max\|w - w_dense\| = ([-+.\de]+)", out) <= 1e-6
    assert "bitwise = True" in out
    saved = _float(r"wire bytes saved vs sync full participation: "
                   r"(\d+)%", out)
    assert 0 < saved < 100


def test_distributed_nlasso_two_ranks():
    out = run_example("distributed_nlasso_torch.py", "--ranks", "2")
    assert "mesh: {'data': 2, 'model': 1}" in out
    for partitioner in ("block", "cluster"):
        assert f"partitioner={partitioner}: cut edges" in out
    runs = re.findall(r"comm=(\w+)\s+500 iters", out)
    assert runs == ["dense", "boundary"] * 2, out
    # sharded vs dense in a gloo world: the port's RANK_TOL (the
    # reference's sharded tolerance)
    assert _float(r"max \|sharded - dense\| after 500 iters: "
                  r"([-+.\de]+)", out) <= 2e-4

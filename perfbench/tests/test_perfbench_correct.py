"""``correct`` on the CPU at a tiny size: true for the program as it is,
false for the control (the program's bfloat16 storage path) and for each
fault a cell can have, planted under the timed path."""
import pytest

from _tiny import run_tiny

CASES = [
    ("squared.solve_tol", None, None, True),
    ("squared.solve_tol", None, "bfloat16", False),
    ("squared.solve_tol", "frozen", None, False),
    ("squared.solve_tol", "altered", None, False),
    ("logistic.solve_tol", None, None, True),
    ("logistic.solve_tol", "altered", None, False),
    ("squared.lam_path", None, None, True),
    ("squared.lam_path", "half_lanes", None, False),
    ("squared.lam_path", "frozen", None, False),
    ("squared.serve_drift", None, None, True),
    ("squared.serve_drift", "half_delta", None, False),
    ("squared.serve_drift", "altered", None, False),
]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("perfbench_cache")


@pytest.mark.parametrize("cell,fault,dtype,want", CASES)
def test_correct(cache, cell, fault, dtype, want):
    calls = {"squared.serve_drift": 7, "logistic.solve_tol": 1}.get(cell, 2)
    out = run_tiny(cell, cache, fault=fault, dtype=dtype, calls=calls)
    assert out["correct"] is want, out["compared"]
    assert list(out)[-1] == "compared"

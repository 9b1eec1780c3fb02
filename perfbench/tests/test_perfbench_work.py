"""``work.py`` against counts made by hand."""
import _tiny  # noqa: F401  (puts the checkout on the path)
import pytest

from perfbench import work


def test_squared_one_lane():
    # V = 10, E = 20, n = 2, 3 labeled, f32
    w = work.step_work(nodes=10, edges=20, n=2, m=5, labeled=3,
                       loss="squared")
    state = (10 + 20) * 2 * 4                    # w and u
    shared = 20 * 12 + 10 * 4 + 3 * (2 * 2 + 2) * 4
    assert w["bytes_read"] == state + shared == 240 + 240 + 40 + 72
    assert w["bytes_written"] == state
    edge = 2 + 1 + 4 + 5 + 3                     # per edge and feature
    node = 2 + 2 + 3 + 3                         # per node and feature
    assert w["flops"] == 20 * 2 * edge + 10 * 2 * node + 3 * (8 + 2)


def test_logistic_prox():
    # n = 2, m = 8, 8 Newton steps
    per_sample = 4 + 4 + 4 + 2 + 6
    solve = 8 // 3 + 8 + 8
    assert work.prox_flops("logistic", 2, 8, num_inner=8) == 8 * (
        8 * per_sample + solve)
    assert work.prox_floats("logistic", 2, 8) == 24
    w = work.step_work(nodes=10, edges=20, n=2, m=8, labeled=3,
                       loss="logistic")
    assert w["bytes_read"] == 240 + 20 * 12 + 40 + 3 * 24 * 4


def test_lanes_share_the_graph():
    one = work.step_work(nodes=100, edges=1000, n=2, m=5, labeled=10,
                         loss="squared")
    six = work.step_work(nodes=100, edges=1000, n=2, m=5, labeled=10,
                         loss="squared", lanes=6)
    state = (100 + 1000) * 2 * 4
    assert six["bytes_read"] - one["bytes_read"] == 5 * state
    assert six["bytes_written"] == 6 * one["bytes_written"]
    assert six["flops"] == 6 * one["flops"]


def test_least_seconds_takes_the_longer_bound():
    w = {"bytes_read": 3.35e12, "bytes_written": 0, "flops": 67e12 * 2}
    assert work.least_seconds(w) == pytest.approx(2.0)      # operations
    w["flops"] = 0
    assert work.least_seconds(w) == pytest.approx(1.0)      # bytes


def test_full_size_squared_step():
    # the cells' shapes: 1M nodes, ~10.2M edges, 100,000 labeled
    w = work.step_work(nodes=1_000_000, edges=10_200_000, n=2, m=5,
                       labeled=100_000, loss="squared")
    t_bytes = (w["bytes_read"] + w["bytes_written"]) / work.HBM_BYTES_PER_S
    assert work.least_seconds(w) == t_bytes
    assert 0.08e-3 < work.least_seconds(w) < 0.11e-3

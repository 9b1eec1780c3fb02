"""The device trace's arithmetic: busy time is the union of the device
operations' intervals, so idle never reads below 0 or busy above the
window."""
import _tiny  # noqa: F401
import pytest

from perfbench import devtrace


def trace(ops, window=10.0, ranges=()):
    return devtrace.Trace(ops=list(ops), ranges=list(ranges),
                          window_s=window)


def test_overlaps_count_once():
    t = trace([("a", 0.0, 4.0), ("b", 2.0, 6.0), ("c", 5.0, 7.0),
               ("d", 8.0, 9.0)])
    assert t.busy_s() == pytest.approx(8.0)
    assert t.idle_pct() == pytest.approx(20.0)


def test_nested_and_clipped():
    t = trace([("a", -1.0, 11.0), ("b", 1.0, 2.0), ("c", 1.5, 1.7)])
    assert t.busy_s() == pytest.approx(10.0)
    assert t.idle_pct() == pytest.approx(0.0)


def test_never_above_the_window():
    ops = [(f"k{i}", 0.1 * i, 0.1 * i + 3.0) for i in range(100)]
    t = trace(ops)
    assert 0.0 <= t.busy_s() <= t.window_s
    assert 0.0 <= t.idle_pct() <= 100.0
    # summed durations, the mistake avoided, would read 30 s of 10
    assert sum(e - s for _, s, e in ops) > t.window_s


def test_empty_window_is_all_idle():
    assert trace([]).idle_pct() == pytest.approx(100.0)


def test_idle_gaps_named_by_host_range():
    t = trace([("k", 0.0, 1.0), ("k", 4.0, 5.0), ("k", 5.5, 10.0)],
              ranges=[("solver.run", 0.0, 6.0), ("inner", 1.5, 2.0),
                      ("weights_to_host", 5.0, 5.6)])
    gaps = t.idle_gaps(5)
    assert gaps[0] == ["solver.run", pytest.approx(3.0)]
    assert gaps[1] == ["weights_to_host", pytest.approx(0.5)]


def test_op_seconds_and_top_ops():
    t = trace([("void fused_pd_step_kernel<2, 0>(PdArgs, Plan)", 0, 2.0),
               ("void fused_pd_step_lanes_kernel<2, 0>(PdArgs)", 2.0, 3.0),
               ("void fused_pd_step_kernel<2, 0>(PdArgs, Plan)", 3.0, 4.0)])
    assert t.op_seconds(("fused_pd_step_kernel",)) == (
        pytest.approx(3.0), 2)
    assert t.top_ops(1) == [["fused_pd_step_kernel", pytest.approx(3.0)]]

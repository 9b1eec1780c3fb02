"""The request tail's arithmetic: the nearest-rank 90th percentile and
the count of requests beyond it."""
import _tiny  # noqa: F401

from perfbench.kinds import serve


def test_nearest_rank():
    xs = list(range(1, 101))                    # 1..100
    assert serve.nearest_rank(xs, 0.90) == 90
    assert serve.beyond(100, 0.90) == 10
    assert serve.nearest_rank(xs[:99], 0.90) == 90   # ceil(89.1) = 90
    assert serve.beyond(99, 0.90) == 9
    assert serve.nearest_rank([5.0], 0.90) == 5.0


def test_ten_beyond_needs_a_hundred():
    assert min(n for n in range(1, 500) if serve.beyond(n, 0.90) >= 10) \
        == 100


def test_end_to_end_reads_milliseconds():
    recs = [{"seconds": s / 1000.0} for s in range(1, 201)]
    assert serve.end_to_end(recs, 1.0)["request_p90_ms"] == 180.0

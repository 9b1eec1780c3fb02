"""idle_pct.serve: share of the traced window with no device operation
running (device layer; moves request_p90_ms)."""
from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run, "serve")

"""idle_pct.path: share of the traced window with no device operation
running (device layer; moves sweep_s)."""
from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run, "path")

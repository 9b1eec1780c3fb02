"""idle_pct.solve: share of the traced window with no device operation
running (device layer; moves solve_s)."""
from perfbench.readers import idle_pct


def read(run):
    return idle_pct(run, "solve")

"""step_mfu.solve: the whole step's share of the H100's peak over the
window (model step layer; moves solve_s)."""
from perfbench.readers import step_mfu_pct


def read(run):
    return step_mfu_pct(run, "solve")

"""step_mfu.serve: the whole step's share of the H100's peak over the
window (model step layer; moves request_p90_ms)."""
from perfbench.readers import step_mfu_pct


def read(run):
    return step_mfu_pct(run, "serve")

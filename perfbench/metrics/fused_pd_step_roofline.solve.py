"""fused_pd_step_roofline.solve: the one-lane fused kernel's share of
its roofline in the tol solves (kernels layer; moves solve_s)."""
from perfbench.readers import ONE_LANE_KERNEL, roofline_pct


def read(run):
    return roofline_pct(run, "solve", ONE_LANE_KERNEL, lanes=False)

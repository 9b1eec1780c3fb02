"""fused_pd_step_lanes_roofline.path: the lane kernel's share of its
roofline in the sweeps' lane phase (kernels layer; moves sweep_s)."""
from perfbench.readers import LANES_KERNEL, roofline_pct


def read(run):
    return roofline_pct(run, "path", LANES_KERNEL, lanes=True)

"""k5_roofline: percent of its bound that K5, the fused block-Jacobi sweep
on bf16 node blocks (the fine level at refine level 5, 455,184 nodes),
reaches in the traced requests: the launches' bound times, each at its own
mode's layout bytes (`roofline.sweep_cost`) at 3.35 TB/s, over their
device time."""
from port_bench.metrics._node_blocks import SWEEP_SPAN, share, sweep_bound

SPANS = [SWEEP_SPAN]


def read(run, trace):
    return share(trace, "sweep 2 ", sweep_bound)

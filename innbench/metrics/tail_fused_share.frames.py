"""The share of the SR tail's convs that ran on the hand-written tail conv:
the program's counters ``tail_convs_fused`` over ``tail_convs``
(``models/common.py``); 1 where every conv of the tail fused its bias,
activation and layout into the kernel."""
from innbench.metrics.spans import counter_ratio


def read(ctx):
    return counter_ratio("tail_convs_fused", "tail_convs")

"""The share of HAT's overlapping cross-attention blocks whose attention ran
on the hand-written kernel: the program's counters ``overlap_attns_fused``
over ``overlap_attns`` (``models/hat.py``); 1 where every block's OCA read
the qkv projection in place on the kernel.  A program without the counters
reads nothing."""
from innbench.metrics.spans import counter_ratio


def read(ctx):
    return counter_ratio("overlap_attns_fused", "overlap_attns")

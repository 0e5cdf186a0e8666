"""The share of PPON's dilated multi-rate blocks that ran on the
hand-written block kernel: the program's counters ``dilated_blocks_fused``
over ``dilated_blocks`` (``models/ppon.py``); 1 where every block of every
frame did."""
from innbench.metrics.spans import counter_ratio


def read(ctx):
    return counter_ratio("dilated_blocks_fused", "dilated_blocks")

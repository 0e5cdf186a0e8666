"""The share of the CycleGAN generator's instance norms outside its residual
blocks that ran on the hand-written norm kernel: the program's counters
``norms_fused`` over ``norms`` (``models/resnet.py``); 1 where every norm of
every frame did."""
from innbench.metrics.spans import counter_ratio


def read(ctx):
    return counter_ratio("norms_fused", "norms")

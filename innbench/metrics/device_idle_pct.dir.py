"""The card's idle share over the traced window of the directory cells."""
from innbench.metrics.idle import idle_pct


def read(ctx):
    return idle_pct(ctx)

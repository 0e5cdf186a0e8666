"""Milliseconds the directory loop waits for the next decoded image, per
image: the program's ``read`` stage (``observability.StageTimers`` around
the prefetch loader in ``pipeline.process``) over the window."""


def read(ctx):
    row = (ctx.window.timers or {}).get("read")
    return 1e3 * row["total_s"] / row["count"] if row and row["count"] else None

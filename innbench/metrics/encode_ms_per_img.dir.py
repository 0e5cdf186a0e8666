"""Thread-milliseconds of PNG encode per image: the program's ``encode``
stage (``observability.StageTimers`` in ``pipeline.process``, on the
encode pool's threads) over the window, per image encoded."""


def read(ctx):
    row = (ctx.window.timers or {}).get("encode")
    return 1e3 * row["total_s"] / row["count"] if row and row["count"] else None

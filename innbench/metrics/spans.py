"""The arithmetic of the readers of the program's own spans and counters
(``innfer_tpu_torch.observability``, recorded while the traced window's
profiler records): per frame is over the count of ``innfer.frame`` spans.
Each returns None where the program has no tracer (an older checkout), no
frame was recorded, or, for a time, the spans have no device timings (the
CPU)."""
from __future__ import annotations


def _summary(timed: bool) -> "dict | None":
    """The tracer's summary, where it holds a frame (``timed``: with device
    timings)."""
    try:
        from innfer_tpu_torch import observability
    except ImportError:
        return None
    get = getattr(observability, "summary", None)
    if get is None:
        return None
    s = get()
    frame = s["spans"].get("innfer.frame")
    if not frame or not frame["count"] or (timed and frame["device_ms"] is None):
        return None
    return s


def device_ms_per_frame(names, key: str = "device_ms") -> "float | None":
    """The summed ``key`` (``device_ms`` or ``device_self_ms``) of the
    spans ``names``, per frame."""
    s = _summary(timed=True)
    if s is None:
        return None
    vals = [s["spans"].get(n, {}).get(key) for n in names]
    if any(v is None for v in vals):
        return None
    return sum(vals) / s["spans"]["innfer.frame"]["count"]


def enqueue_ms_per_frame() -> "float | None":
    """Host ms of ``innfer.frame`` less host ms of ``innfer.fetch``, per
    frame: how long the host takes to issue a frame's work."""
    s = _summary(timed=True)
    if s is None:
        return None
    frame = s["spans"]["innfer.frame"]
    fetch = s["spans"].get("innfer.fetch", {}).get("host_ms", 0.0)
    return (frame["host_ms"] - fetch) / frame["count"]


def counter_ratio(num: str, den: str) -> "float | None":
    """Counter ``num`` over counter ``den``."""
    s = _summary(timed=False)
    if s is None or not s["counters"].get(den):
        return None
    return s["counters"].get(num, 0) / s["counters"][den]

"""tick_ms.with_read: ``tick_ms`` in the cells whose ticks carry the
planner's read, where its runs spread too widely to be held end to end:
the mean interval between consecutive tick ends (CUDA events) over the
window's ticks outside the traced orbits and the tick after each, which
sum to that part's device span: its time over its ticks."""


def read(reading):
    ms = reading.intervals_ms
    return sum(ms) / len(ms) if ms else None

"""tick_host_ms: host milliseconds a tick inside the program's own
``fiesta.tick`` span (``fused_batch_step`` / ``fused_depth_batch_step``),
on the program's host clock, over the span orbit (``spans.py``: spans on
in memory, no profiler): ``dispatch_ms`` measured where the work
happens, and the sum its layers' host metrics split."""

from esdfbench import spans


def read(reading):
    found = spans.measure(reading)
    return None if found is None else found["host_ms"].get(spans.TICK, 0.0)

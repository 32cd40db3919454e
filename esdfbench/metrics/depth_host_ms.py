"""depth_host_ms: host milliseconds a tick inside the program's
``fiesta.depth`` span (the K depth images' back-projection and
consistency filter, and the stacks), over the span orbit (``spans.py``):
the host's share of the plain depth ops, what a fused depth kernel or a
CUDA graph would cut."""

from esdfbench import spans


def read(reading):
    found = spans.measure(reading)
    return None if found is None else found["host_ms"].get("fiesta.depth",
                                                           0.0)

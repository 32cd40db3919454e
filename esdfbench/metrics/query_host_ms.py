"""query_host_ms: host milliseconds a tick around the planner's read
(the distance grid, the distance at every sample, the trilinear reads
along the refinement's trajectories), on the host clock in the span
orbits' orbit with the spans off (``spans.py``): what the host spends to
enqueue the read after each tick, which caching the distance grid or
fusing the gathers would cut.  Nothing where the cell does not read the
map."""

from esdfbench import spans


def read(reading):
    found = spans.measure(reading)
    return None if found is None else found.get("read_ms")

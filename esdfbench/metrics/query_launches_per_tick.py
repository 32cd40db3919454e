"""query_launches_per_tick: device operations (kernels, copies, fills) a
tick whose runtime call lies inside the harness's range around the
planner's read (``harness.READ_MARK``), found by correlation id in the
span-trace orbit (``spans.py``): the launches the host enqueues for the
read after each tick.  Nothing where the cell does not read the map."""

from esdfbench import spans


def read(reading):
    found = spans.measure(reading)
    if found is None or found["read"] is None:
        return None
    return found["read"]["launches"]

"""launches_per_tick: device operations (kernels, copies, fills) a tick
whose runtime call lies under the program's ``fiesta.tick`` span, found
by correlation id in the span-trace orbit (``spans.py``): the launches a
CUDA graph of the tick would replace, and what the host's enqueue
pays for."""

from esdfbench import spans


def read(reading):
    found = spans.measure(reading)
    return None if found is None else found["tick"]["launches"]

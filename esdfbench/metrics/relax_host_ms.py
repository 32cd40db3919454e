"""relax_host_ms: host milliseconds a tick inside the program's
``fiesta.update.relax`` span (``esdf.update_esdf``: the tick's inserts
and resets, and the relaxation's launch), over the span orbit
(``spans.py``)."""

from esdfbench import spans


def read(reading):
    found = spans.measure(reading)
    return None if found is None else found["host_ms"].get(
        "fiesta.update.relax")

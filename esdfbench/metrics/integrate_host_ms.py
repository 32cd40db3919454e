"""integrate_host_ms: host milliseconds a tick inside the program's
``fiesta.integrate`` span (``integrate_scan_batch``: the splat prep, the
splat, the carve with its window gate, the box add), over the span orbit
(``spans.py``)."""

from esdfbench import spans


def read(reading):
    found = spans.measure(reading)
    return None if found is None else found["host_ms"].get(
        "fiesta.integrate", 0.0)

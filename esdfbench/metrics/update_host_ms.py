"""update_host_ms: host milliseconds a tick inside the program's
``fiesta.update`` span (``esdf_update``: the drain and the EDT), over the
span orbit (``spans.py``)."""

from esdfbench import spans


def read(reading):
    found = spans.measure(reading)
    return None if found is None else found["host_ms"].get("fiesta.update",
                                                           0.0)

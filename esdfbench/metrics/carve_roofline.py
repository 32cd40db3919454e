"""carve_roofline: the carve's share of its roofline, in per cent: the
least time the card could take for a tick's carve work
(``roofline.carve_bound_s``: K boxes of the cell's carve-box shape) over
the device time a tick of its kernels (``kernels/carve.cu``) in the
traced slice.  The card's power limit is in the result's ``device``."""

from esdfbench import roofline

KERNELS = ("carve_zero", "carve_sweep")


def read(reading):
    s = reading.slice
    if s is None or not s.ticks:
        return None
    t = sum(s.by_name.get(k, 0.0) for k in KERNELS) / s.ticks
    if t <= 0:
        return None
    k = reading.cell.traffic["scans_per_tick"]
    bound, _ = roofline.carve_bound_s(k, reading.geometry.box)
    return 100.0 * bound / t

"""edt_roofline: the EDT's share of its roofline, in per cent: the least
time the card could take for a tick's exact truncated EDT of the grid
(``roofline.edt_bound_s``: the binary pass and two min-plus passes) over
the device time a tick of its kernels (``kernels/edt.cu``) in the traced
slice.  The card's power limit is in the result's ``device``."""

from esdfbench import roofline

KERNELS = ("edt_binary_kernel", "edt_minplus_kernel")


def read(reading):
    s = reading.slice
    if s is None or not s.ticks:
        return None
    t = sum(s.by_name.get(k, 0.0) for k in KERNELS) / s.ticks
    if t <= 0:
        return None
    bound, _ = roofline.edt_bound_s(reading.geometry.grid)
    return 100.0 * bound / t

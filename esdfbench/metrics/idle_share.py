"""idle_share: the device's idle share of the traced slice, in per cent:
1 - busy / wall, busy the union of the device operations' intervals
within the slice and wall its span, both from the same trace."""


def read(reading):
    s = reading.slice
    if s is None or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)

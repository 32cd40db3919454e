"""sweeps_per_tick: the relaxation's sweeps a tick, the mean of the
program's ``UpdateStats.num_sweeps`` over the window's ticks; the check
holds this counter to the reference on the ticks it replays."""


def read(reading):
    st = reading.stats
    if st is None or not len(st):
        return None
    value = float(st[:, 3].double().mean())
    return value if value > 0 else None

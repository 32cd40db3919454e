"""relax_roofline: the relaxation's share of its roofline, in per cent,
over the ``check.STRETCH_TICKS`` ticks that open the traced device
slice: the least time the card could take for their relaxations
(``roofline.relax_bound_s`` of each tick's work, as the reference counts
it following the program's map from before the slice,
``check.relax_work``; the check holds their sweeps to the program's)
over the device time of the ``kernels/relax.cu`` kernels that start
before the slice's cut (``trace.cut``), which follows those ticks.  The
card's power limit is in the result's ``device``."""

from esdfbench import roofline, trace


def read(reading):
    s = reading.slice
    work = reading.work
    if s is None or not s.cuts or not work or reading.kernel_dir is None:
        return None
    names = trace.hand_kernel_names(reading.kernel_dir, "relax.cu")
    t = sum(sec for k in names for a, sec in s.series.get(k, ())
            if a < s.cuts[0])
    bound = sum(roofline.relax_bound_s(pairs, changed)[0]
                for _, pairs, changed in work)
    return 100.0 * bound / t if t > 0 and bound > 0 else None

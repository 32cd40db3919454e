"""host_syncs_per_tick.with_read: ``host_syncs_per_tick`` in the cells whose ticks carry the
planner's read, which report ``tick_p95_ms`` and not ``tick_ms`` end
to end: the same reading, by the same reader (``host_syncs_per_tick.py``)."""

from pathlib import Path

from esdfbench import spec

read = spec.load_module(Path(__file__).with_name("host_syncs_per_tick.py"),
                        "esdfbench_metric_host_syncs_per_tick_base").read

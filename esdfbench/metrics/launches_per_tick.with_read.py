"""launches_per_tick.with_read: ``launches_per_tick`` in the cells whose ticks carry the
planner's read, which report ``tick_p95_ms`` and not ``tick_ms`` end
to end: the same reading, by the same reader (``launches_per_tick.py``)."""

from pathlib import Path

from esdfbench import spec

read = spec.load_module(Path(__file__).with_name("launches_per_tick.py"),
                        "esdfbench_metric_launches_per_tick_base").read

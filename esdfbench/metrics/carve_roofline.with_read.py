"""carve_roofline.with_read: ``carve_roofline`` in the cells whose ticks carry the
planner's read, which report ``tick_p95_ms`` and not ``tick_ms`` end
to end: the same reading, by the same reader (``carve_roofline.py``)."""

from pathlib import Path

from esdfbench import spec

read = spec.load_module(Path(__file__).with_name("carve_roofline.py"),
                        "esdfbench_metric_carve_roofline_base").read

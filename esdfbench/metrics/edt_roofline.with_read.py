"""edt_roofline.with_read: ``edt_roofline`` in the cells whose ticks carry the
planner's read, which report ``tick_p95_ms`` and not ``tick_ms`` end
to end: the same reading, by the same reader (``edt_roofline.py``)."""

from pathlib import Path

from esdfbench import spec

read = spec.load_module(Path(__file__).with_name("edt_roofline.py"),
                        "esdfbench_metric_edt_roofline_base").read

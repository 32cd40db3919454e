"""dispatch_ms.with_read: ``dispatch_ms`` in the cells whose ticks carry the
planner's read, which report ``tick_p95_ms`` and not ``tick_ms`` end
to end: the same reading, by the same reader (``dispatch_ms.py``)."""

from pathlib import Path

from esdfbench import spec

read = spec.load_module(Path(__file__).with_name("dispatch_ms.py"),
                        "esdfbench_metric_dispatch_ms_base").read

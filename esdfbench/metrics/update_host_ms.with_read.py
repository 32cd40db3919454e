"""update_host_ms.with_read: ``update_host_ms`` in the cells whose ticks carry the
planner's read, which report ``tick_p95_ms`` and not ``tick_ms`` end
to end: the same reading, by the same reader (``update_host_ms.py``)."""

from pathlib import Path

from esdfbench import spec

read = spec.load_module(Path(__file__).with_name("update_host_ms.py"),
                        "esdfbench_metric_update_host_ms_base").read

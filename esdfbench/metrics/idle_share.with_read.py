"""idle_share.with_read: ``idle_share`` in the cells whose ticks carry the
planner's read, which report ``tick_p95_ms`` and not ``tick_ms`` end
to end: the same reading, by the same reader (``idle_share.py``)."""

from pathlib import Path

from esdfbench import spec

read = spec.load_module(Path(__file__).with_name("idle_share.py"),
                        "esdfbench_metric_idle_share_base").read

"""The planner that reads the map (port of ``fiesta_tpu/planning``):
sampling MPC with ESDF-gradient refinement (``mpc``)."""

from . import mpc  # noqa: F401

"""The planner that reads the map (port of ``fiesta_tpu/planning``):
sampling MPC with ESDF-gradient refinement (``mpc``), and its independent
numpy float64 oracle (``reference_planner``)."""

from . import mpc  # noqa: F401

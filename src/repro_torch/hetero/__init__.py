"""Heterogeneity subsystem: cost models and mask controllers."""

from .controller import (  # noqa: F401
    Controller,
    PolicyController,
    Telemetry,
    as_controller,
    initial_telemetry,
    next_telemetry,
)
from .cost import (  # noqa: F401
    CostModel,
    available,
    capacity,
    round_time,
    time_to_target,
    uniform_cost,
    worker_times,
)

"""Heterogeneity subsystem: cost models, cluster scenarios and mask
controllers."""

from .controller import (  # noqa: F401
    Controller,
    PolicyController,
    QuorumController,
    ResourceProportionalController,
    StalenessBoundedController,
    Telemetry,
    as_controller,
    initial_telemetry,
    make_controller,
    next_telemetry,
)
from .cost import (  # noqa: F401
    CostModel,
    available,
    capacity,
    on_device,
    pareto_cost,
    pod_exchange_time,
    quorum_deadline,
    quorum_split,
    round_time,
    time_to_target,
    uniform_cost,
    with_availability,
    with_overlap_credit,
    with_topology,
    worker_times,
)
from .scenarios import (  # noqa: F401
    SCENARIOS,
    Scenario,
    dirichlet_weights,
    make_scenario,
    pod_uplinks,
    scenario_problem,
)

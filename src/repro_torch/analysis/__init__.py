"""Checks of the port's runs: the communication contracts, held to a
run's collective log, and the largest tensor a run makes."""

from .contracts import CommContract, check_log, engine_contract, \
    memory_ceiling, train_contract  # noqa: F401
from .memory import LargestTensors  # noqa: F401

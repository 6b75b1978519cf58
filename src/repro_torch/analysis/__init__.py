"""Static checks of the port's runs: the communication contracts."""

from .contracts import CommContract, check_log, engine_contract  # noqa: F401

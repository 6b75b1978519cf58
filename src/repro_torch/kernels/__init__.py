"""Hand-written GPU kernels of the port, their plain twins and dispatch.

  region_aggregate / ranl_update — the server aggregation (Algorithm 1
      lines 15–22), fused; ranl_update also applies the diagonal
      projected-Newton step.  Triton, for Hopper.

``ops`` dispatches by device; ``ref`` holds the plain versions;
``LAUNCHES`` counts kernel launches.
"""

from . import ops, ref  # noqa: F401
from .region_aggregate import LAUNCHES, reset_launches  # noqa: F401

"""PyTorch port of the RANL reproduction (adaptive pruning-based Newton
for distributed learning), for one NVIDIA H100.

``repro_torch.run(problem, key, ...)`` mirrors ``repro.run`` with the
port's engines ("scan", "batch", "sharded" and "sharded2d" on
``torch.distributed``, and "reference"); ``repro_torch.prng``
reproduces the reference's random streams, and ``repro_torch.kernels``
holds the hand-written GPU kernels with their plain twins.  Entry points
run on the CUDA card unless the caller passes ``device="cpu"``.
"""

from . import prng  # noqa: F401
from .api import ENGINES, run  # noqa: F401
from .core.convex import Logistic, Quadratic, make_logistic, make_quadratic  # noqa: F401
from .core.masks import PolicyConfig  # noqa: F401
from .core.options import EngineDeprecationWarning, QuorumSpec, RanlOptions  # noqa: F401
from .core.ranl import RanlResult  # noqa: F401

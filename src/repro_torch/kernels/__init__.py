"""Hand-written GPU kernels of the port, their plain twins and dispatch.

  region_aggregate / ranl_update — the server aggregation (Algorithm 1
      lines 15–22), fused; ranl_update also applies the diagonal
      projected-Newton step.  Triton, for Hopper.
  flash_attention — causal GQA self-attention with a sliding window.
      CUDA C++ (``csrc/flash_attention.cu``), for Hopper.
  rwkv_wkv — the RWKV-6 wkv recurrence.  CUDA C++ (``csrc/rwkv_wkv.cu``).
  chol_update — the low-rank Cholesky update of the ``hessian_rank``
      init, r rank-1 sweeps in one launch.  CUDA C++
      (``csrc/chol_update.cu``); it ports no Pallas kernel.

flash_attention and rwkv_wkv carry gradients: their backward is the
vector-Jacobian product of the plain twin (``ops.with_twin_grad``).

``ops`` dispatches by device; ``ref`` holds the plain versions;
``LAUNCHES`` counts kernel launches; ``build`` compiles the CUDA sources.
"""

from . import ops, ref  # noqa: F401
from .launches import LAUNCHES, reset_launches  # noqa: F401

"""Hand-written GPU kernels of the port, their plain twins and dispatch.

  region_aggregate / ranl_update — the server aggregation (Algorithm 1
      lines 15–22), fused; ranl_update also applies the diagonal
      projected-Newton step.  Triton, for Hopper.
  flash_attention — causal GQA self-attention with a sliding window.
      CUDA C++ (``csrc/flash_attention.cu``), for Hopper.
  rwkv_wkv — the RWKV-6 wkv recurrence.  CUDA C++ (``csrc/rwkv_wkv.cu``).
  flash_attention_bwd / rwkv_wkv_bwd — their backwards.  CUDA C++
      (``csrc/flash_attention_bwd.cu``, ``csrc/rwkv_wkv_bwd.cu``); they
      replace XLA's autodiff of the reference, no Pallas kernel.
  chol_update — the low-rank Cholesky update of the ``hessian_rank``
      init, r rank-1 sweeps in one launch.  CUDA C++
      (``csrc/chol_update.cu``); it ports no Pallas kernel.
  masked_aggregate — one leaf of the deep-net RANL aggregate: G and the
      stored memory read once, g and the new memory written once.  CUDA
      C++ (``csrc/masked_aggregate.cu``); it ports no Pallas kernel (the
      reference's is plain ``jnp``).
  newton_step — RANL's diagonal Newton step over every leaf of a round:
      a pass over h, then two over p, g and h, one launch each.  CUDA C++
      (``csrc/newton_step.cu``); it ports no Pallas kernel (the
      reference's is plain ``jnp``).

  grouped_matmul — y = x[rows of g] · w[g] over the groups of rows that
      int32 offsets on the card give, and its backward's two products:
      the experts held on one card of the dropless MoE layer.  CUDA C++
      (``csrc/grouped_matmul.cu``); it ports no Pallas kernel.

flash_attention, rwkv_wkv and grouped_matmul carry gradients: ``ops``
wraps each in a ``torch.autograd.Function`` whose backward is the
backward kernel on the card and the plain backward (``ref.*_bwd_ref``,
``ref.grouped_matmul_ref`` and ``ref.grouped_matmul_wgrad_ref``) on the
CPU.

``ops`` dispatches by device; ``ref`` holds the plain versions;
``LAUNCHES`` counts kernel launches; ``build`` compiles the CUDA sources.
"""

from . import ops, ref  # noqa: F401
from .launches import LAUNCHES, reset_launches  # noqa: F401

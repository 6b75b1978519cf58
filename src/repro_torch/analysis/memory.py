"""The largest tensor a run makes, recorded by a ``TorchDispatchMode``.

The reference proves the 2-D engine's memory claim on compiled HLO (the
largest buffer of the partitioned program); the port runs eagerly, so it
records instead the largest output of every operator dispatched while
the mode is on.  An output whose storage is one of the operator's inputs'
(a view, an in-place or ``out=`` result) allocates nothing and is not
counted, so the problem's own tensors and views of them never are.  The
same on the CPU and on the card; ``analysis.contracts.memory_ceiling``
gives the bound to hold it to.

    with LargestTensors() as rec:
        res = repro_torch.run(...)
    rec.max_bytes, rec.max_op
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _storage_ptr(t) -> int | None:
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):     # no storage (meta, …)
        return None


class LargestTensors(TorchDispatchMode):
    """``max_bytes``: the bytes of the largest freshly allocated operator
    output seen (the larger of the tensor's and its storage's size);
    ``max_op``: that operator's name and the output's shape."""

    def __init__(self):
        super().__init__()
        self.max_bytes = 0
        self.max_op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        held = {_storage_ptr(t) for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            ptr = _storage_ptr(t)
            if ptr is None or ptr in held:
                continue
            nbytes = max(t.numel() * t.element_size(),
                         t.untyped_storage().nbytes())
            if nbytes > self.max_bytes:
                self.max_bytes = nbytes
                self.max_op = (str(func), tuple(t.shape))
        return out

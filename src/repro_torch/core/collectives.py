"""The sharded engines' collectives, each through one recorder.

A ``Collectives`` object is bound to a ``torch.distributed.device_mesh.
DeviceMesh`` with named dimensions.  Every collective an engine starts
goes through it: it runs the ``torch.distributed`` call on the process
group of the named mesh dimension and logs one ``Collective`` record —
the dimension, the op, the dtype and bytes of the tensor this rank puts
on the wire, and the round the call fell in (``None`` outside the round
loop; the engine sets ``round``).  ``analysis.contracts.check_log`` holds
such a log to the engine's communication contract.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Collective:
    """One logged collective: ``op`` is ``"sum"``, ``"max"`` (all-reduce)
    or ``"all_gather"``; ``dtype`` the wire tensor's (``"float32"``,
    ``"int8"``, ...); ``nbytes`` the bytes this rank contributes."""
    dim: str
    op: str
    dtype: str
    nbytes: int
    round: int | None


class Pending:
    """A started all-reduce: ``wait()`` blocks until it has completed and
    returns the reduced tensor, passed through ``then`` when given."""

    def __init__(self, tensor, work=None, then=None):
        self._tensor, self._work, self._then = tensor, work, then

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._tensor if self._then is None else self._then(
            self._tensor)


class Collectives:
    """The recorder: ``all_reduce`` and ``all_gather`` over a named
    dimension of ``mesh``, each logged in ``log``."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names or ())
        self.round = None
        self.log: list[Collective] = []

    def size(self, dim: str) -> int:
        return self.mesh.size(self.names.index(dim))

    def rank(self, dim: str) -> int:
        """This rank's index along ``dim``."""
        return self.mesh.get_local_rank(dim)

    def _record(self, dim, op, t):
        self.log.append(Collective(
            dim=dim, op=op, dtype=str(t.dtype).removeprefix("torch."),
            nbytes=t.numel() * t.element_size(), round=self.round))

    def all_reduce(self, t, dim: str, op: str = "sum", *,
                   async_op: bool = False, then=None) -> Pending:
        """Reduce ``t`` in place over ``dim`` (``op`` ``"sum"`` or
        ``"max"``).  Returns a ``Pending``, already complete unless
        ``async_op``."""
        import torch.distributed as dist
        self._record(dim, op, t)
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        work = dist.all_reduce(t, op=red, group=self.mesh.get_group(dim),
                               async_op=async_op)
        return Pending(t, work, then)

    def all_gather(self, t, dim: str) -> torch.Tensor:
        """(n, *t.shape): every rank's ``t`` along ``dim``, in rank order."""
        import torch.distributed as dist
        self._record(dim, "all_gather", t)
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size(dim))]
        dist.all_gather(out, t, group=self.mesh.get_group(dim))
        return torch.stack(out)

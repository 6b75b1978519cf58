"""The sharded engines' collectives, each through one recorder.

A ``Collectives`` object is bound to a ``torch.distributed.device_mesh.
DeviceMesh`` with named dimensions.  Every collective an engine starts
goes through it: it runs the ``torch.distributed`` call on the process
group of the named mesh dimension and logs one ``Collective`` record —
the dimension, the op, the dtype and bytes of the tensor this rank puts
on the wire, and the round the call fell in (``None`` outside the round
loop; the engine sets ``round``).  ``analysis.contracts.check_log`` holds
such a log to the engine's communication contract.

A dimension is a mesh dimension name, or a tuple of names for the
plane they span together (``("pod", "data")``: every rank with the same
index along the other dimensions, pod-major), which reduces in one
collective over one process group and is logged as ``"pod+data"``.
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
        self._planes = {}

    def size(self, dim) -> int:
        if isinstance(dim, tuple):
            n = 1
            for d in dim:
                n *= self.size(d)
            return n
        return self.mesh.size(self.names.index(dim))

    def rank(self, dim) -> int:
        """This rank's index along ``dim`` (row-major over a plane)."""
        if isinstance(dim, tuple):
            r = 0
            for d in dim:
                r = r * self.size(d) + self.rank(d)
            return r
        return self.mesh.get_local_rank(dim)

    def group(self, dim):
        """The process group of ``dim``.  A plane of several dimensions
        gets one group a combination of the other dimensions' indices,
        made at first use (every rank makes every group, in one order)."""
        if not isinstance(dim, tuple):
            return self.mesh.get_group(dim)
        if len(dim) == 1:
            return self.mesh.get_group(dim[0])
        if dim not in self._planes:
            import torch.distributed as dist
            axes = [self.names.index(d) for d in dim]
            rest = [i for i in range(len(self.names)) if i not in axes]
            rows = self.mesh.mesh.permute(*rest, *axes).reshape(
                -1, self.size(dim))
            me = dist.get_rank()
            for row in rows.tolist():
                g = dist.new_group(row)
                if me in row:
                    self._planes[dim] = g
        return self._planes[dim]

    def _record(self, dim, op, t):
        name = "+".join(dim) if isinstance(dim, tuple) else dim
        self.log.append(Collective(
            dim=name, op=op, dtype=str(t.dtype).removeprefix("torch."),
            nbytes=t.numel() * t.element_size(), round=self.round))

    def all_reduce(self, t, dim, op: str = "sum", *,
                   async_op: bool = False, then=None) -> Pending:
        """Reduce ``t`` in place over ``dim`` (``op`` ``"sum"`` or
        ``"max"``).  Returns a ``Pending``, already complete unless
        ``async_op``."""
        import torch.distributed as dist
        self._record(dim, op, t)
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        work = dist.all_reduce(t, op=red, group=self.group(dim),
                               async_op=async_op)
        return Pending(t, work, then)

    def all_gather(self, t, dim) -> torch.Tensor:
        """(n, *t.shape): every rank's ``t`` along ``dim``, in rank order."""
        import torch.distributed as dist
        self._record(dim, "all_gather", t)
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.size(dim))]
        dist.all_gather(out, t, group=self.group(dim))
        return torch.stack(out)

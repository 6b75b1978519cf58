"""The engine mesh on ``torch.distributed``.

Port of the reference's ``launch/mesh.py::make_engine_mesh``,
``data_shards`` and ``model_shards``.  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dimensions,
built over the default process group, which the caller initialises
(``torchrun --nproc-per-node P`` and ``init_process_group``).  Its
dimension names are ``MESH_AXES``; the lint (``analysis.lint``, RPL004)
holds every mesh-dimension literal of the port to them.
"""

from __future__ import annotations

#: The mesh dimension names the port uses (the reference's declared axes).
MESH_AXES = frozenset({"data", "model", "pod"})


def make_engine_mesh(data_shards: int, model_shards: int = 1,
                     pods: int = 1, device_type: str | None = None):
    """("data", "model") — or, with ``pods > 1``, ("pod", "data",
    "model") — mesh over the pods·data·model ranks of the default group.

    Pod-major, then data-major, row-major rank order, the layout the
    sharded engines assume: the ranks of one pod are contiguous, and the
    model ranks of one worker shard are neighbours.  ``device_type`` None
    means ``"cuda"``, as every entry point of the port defaults to the
    card; ``"cpu"`` runs on gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = pods * data_shards * model_shards
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"mesh ({pods}, {data_shards}, {model_shards}) needs {n} "
            f"ranks but the process group has {world}; start one process "
            f"a rank with torchrun --nproc-per-node {n}")
    device_type = device_type or "cuda"
    if pods > 1:
        return init_device_mesh(device_type, (pods, data_shards,
                                              model_shards),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (data_shards, model_shards),
                            mesh_dim_names=("data", "model"))


def _extent(mesh, name: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    return mesh.size(names.index(name)) if name in names else 1


def data_shards(mesh) -> int:
    """Total batch/worker shards: the product of the pod and data
    extents."""
    return _extent(mesh, "pod") * _extent(mesh, "data")


def model_shards(mesh) -> int:
    return _extent(mesh, "model")

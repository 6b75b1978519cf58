"""``repro_torch.run`` — one dispatcher over the port's engines.

    import repro_torch
    result = repro_torch.run(problem, key, engine="scan",
                             options=repro_torch.RanlOptions(num_rounds=50))

The same options record and the same engine-compatibility checks as the
reference's ``repro.run``, plus the port's own rules:

* the run happens on ``device`` (``None`` = the CUDA card, raising when
  there is none; ``"cpu"`` is the explicit opt-in), and the problem's
  tensors, the cost model's and the mesh's device type must already be
  there — nothing moves silently;
* ``engine="sharded"`` (and a seed-sharded ``"batch"``) take a
  ``torch.distributed.device_mesh.DeviceMesh`` with named dimensions
  (``("data",)``, or ``("pod", "data")`` under ``hierarchy``), and
  ``engine="sharded2d"`` one with ``("data", "model")`` or ``("pod",
  "data", "model")``; every rank calls ``run`` with the same arguments
  (``core.sharded``, ``core.sharded2d``);
* the run never falls back to something else;
* ``journal=`` (a path or an ``obs.Journal``) records the finished run on
  the host after the engine returns, and an active ``obs.tracing()``
  tracer gets one ``execute`` span, timed by CUDA events on the card:
  the run is bit for bit the same with or without either.
"""

from __future__ import annotations

from . import prng
from .core.options import RanlOptions
from .core.ranl import RanlResult, _run_batch, _run_reference, \
    _run_scan  # noqa: F401
from .core.sharded import _run_batch_sharded, _run_sharded
from .core.sharded2d import _run_sharded2d
from .device import resolve_device
from .obs.trace import span

ENGINES = ("scan", "batch", "sharded", "sharded2d", "reference")
_MESH_REQUIRED = ("sharded", "sharded2d")
_MESH_FORBIDDEN = ("scan", "reference")


def _resolve(engine, options, mesh, controller, overrides):
    """Shared validation -> (options, controller).  As the reference's: a
    controller spec string goes through ``make_controller``, and a
    ``QuorumController`` is unwrapped — its knobs move onto the options
    (setting quorum in both places is an error) and its inner controller
    drives the masks."""
    from .hetero.controller import QuorumController, make_controller
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} "
                         f"(expected one of {ENGINES})")
    opts = RanlOptions() if options is None else options
    if not isinstance(opts, RanlOptions):
        raise TypeError(f"options must be a RanlOptions, got {opts!r}")
    if overrides:
        opts = opts.merged(**overrides)
    if engine in _MESH_REQUIRED and mesh is None:
        raise ValueError(f"engine {engine!r} needs a mesh= argument")
    if engine in _MESH_FORBIDDEN and mesh is not None:
        raise ValueError(f"engine {engine!r} takes no mesh — use "
                         f"'sharded'/'sharded2d' (or 'batch' to shard "
                         f"seeds)")
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a torch.distributed.device_mesh"
                            f".DeviceMesh, got {mesh!r}")
    if opts.overlap and engine not in _MESH_REQUIRED:
        raise ValueError(f"overlap=True only exists on the sharded "
                         f"engines, not {engine!r}")
    if engine == "reference":
        if opts.curvature != "dense":
            raise ValueError("the reference engine is the dense-eigh "
                             "oracle — curvature='diag' has no host-loop "
                             "form")
        if opts.projection == "ns":
            raise ValueError("the reference engine is the dense-eigh "
                             "oracle — projection='ns' has no host-loop "
                             "form")
        if opts.hessian_rank is not None:
            raise ValueError("the reference engine is the dense-eigh "
                             "oracle — hessian_rank has no host-loop "
                             "form (use engine='scan')")
        if opts.hierarchy is not None:
            raise ValueError("hierarchy= (pod-of-pods aggregation) has "
                             "no host-loop form on the reference oracle "
                             "— use engine='scan' or a sharded engine "
                             "on a pod mesh")
    if engine == "sharded2d" and opts.hessian_rank is not None:
        raise ValueError(
            "hessian_rank is not implementable on the 2-D engine: its "
            "dense init is panel-sharded (no device may hold the d×d "
            "buffer the rank-r eigh fold reads) — use engine='scan', "
            "'batch' or 'sharded'")
    if isinstance(controller, str):
        controller = make_controller(controller)
    if isinstance(controller, QuorumController):
        if opts.quorum is not None:
            raise ValueError(
                "quorum is configured twice: on the QuorumController AND "
                "on RanlOptions — set it in exactly one place")
        opts = opts.merged(quorum=controller.quorum,
                           quorum_tau=controller.quorum_tau,
                           gamma=controller.gamma,
                           max_delay=controller.max_delay)
        controller = controller.inner
    return opts, controller


def _check_device(problem, device, cost, mesh):
    """The run's device (``device`` resolved); raises where the problem,
    the cost model or the mesh lies elsewhere."""
    dev = resolve_device(device)
    if mesh is not None and mesh.device_type != dev.type:
        raise ValueError(
            f"the mesh is on {mesh.device_type!r}, the run asks for {dev}; "
            f"build the mesh with init_device_mesh({dev.type!r}, ...)")
    held = [("problem", t) for t in problem.tensors()]
    if cost is not None:
        held += [("cost model", cost.compute_rate),
                 ("cost model", cost.bandwidth)]
    if cost is not None and cost.pod_bw is not None:
        held.append(("cost model", cost.pod_bw))
    for what, t in held:
        if t.device.type != dev.type or (
                dev.index is not None and t.device.index != dev.index):
            raise ValueError(
                f"the {what}'s tensors are on {t.device}, the run asks "
                f"for {dev}; build the {what} on that device")
    return dev


def run(problem, key, *, engine: str = "scan",
        options: RanlOptions | None = None, device=None, mesh=None,
        axis_name: str = "data", data_axis: str = "data",
        model_axis: str = "model", pod_axis: str = "pod",
        controller=None, cost=None, journal=None, scenario=None,
        **overrides) -> RanlResult:
    """Run Algorithm 1 on ``problem`` with the chosen engine.

    ``key``: a ``repro_torch.prng`` key (uint32 (2,)), or (B, 2) stacked
    keys for ``engine="batch"``, whose result carries a leading seed
    axis.  ``controller``: a controller object, a ``make_controller``
    spec string or ``None`` (the options' policy); ``cost``: a
    ``CostModel`` on the problem's device or ``None`` (uniform).
    ``mesh``: a ``DeviceMesh`` on the run's device type, for
    ``engine="sharded"`` or ``"sharded2d"`` (required) or to shard a
    batch's seeds.  ``axis_name`` names the worker (or seed) dimension of
    ``"sharded"`` and ``"batch"``; ``data_axis`` and ``model_axis`` the
    worker and parameter dimensions of ``"sharded2d"``; ``pod_axis`` the
    pod dimension of both sharded engines.  The one-card engines take no
    mesh and ignore the axis names, as the reference's do.  ``journal``
    (a path or a ``repro_torch.obs.Journal``) records the finished run —
    header, per-round traces, drift alarms, active spans, summary — on
    the host after the engine returns (a path is written by global rank
    0 alone; see ``obs.journal``).  ``scenario`` labels the journal
    header (defaults to the cost model's scenario name when it has one)
    and is ignored without a journal.  ``**overrides`` are
    ``RanlOptions`` fields merged into ``options``.
    """
    opts, controller = _resolve(engine, options, mesh, controller,
                                overrides)
    dev = _check_device(problem, device, cost, mesh)
    key = prng.as_key(key)
    if engine == "batch":
        if key.ndim != 2 or key.shape[0] < 1:
            raise ValueError(f"engine 'batch' takes stacked keys of shape "
                             f"(B, 2), got {key.shape}")
    elif key.shape != (2,):
        raise ValueError(f"run takes one key of shape (2,), got "
                         f"{key.shape}")
    with span("execute", device=dev, engine=engine):
        if engine == "batch" and mesh is not None:
            result = _run_batch_sharded(problem, key, opts, mesh=mesh,
                                        axis_name=axis_name,
                                        controller=controller, cost=cost)
        elif engine == "batch":
            result = _run_batch(problem, key, opts, controller=controller,
                                cost=cost)
        elif engine == "scan":
            result = _run_scan(problem, key, opts, controller=controller,
                               cost=cost)
        elif engine == "sharded":
            result = _run_sharded(problem, key, opts, mesh=mesh,
                                  axis_name=axis_name, pod_axis=pod_axis,
                                  controller=controller, cost=cost)
        elif engine == "sharded2d":
            result = _run_sharded2d(problem, key, opts, mesh=mesh,
                                    data_axis=data_axis,
                                    model_axis=model_axis,
                                    pod_axis=pod_axis,
                                    controller=controller, cost=cost)
        else:
            result = _run_reference(problem, key, opts,
                                    controller=controller, cost=cost)
    if journal is not None:
        from .obs.journal import write_run_journal
        if scenario is None:
            scenario = getattr(cost, "name", None)
        write_run_journal(journal, result, engine=engine, options=opts,
                          mesh=mesh, problem=problem, scenario=scenario)
    return result

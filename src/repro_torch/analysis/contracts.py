"""Communication contracts of the port's engines, checked on the
collective log (``core.collectives``) of a run.

The reference proves its engines' communication on compiled HLO
(``analysis/contracts.py::engine_contract``); the port has no compiled
program to read, so it holds the log of every collective a run made to
the same promises:

* the one-card engines (``scan``, ``batch``, ``reference``) run no
  collective at all;
* the 1-D sharded engine runs exactly ONE param-sized all-reduce over
  the data dimension per round, its bytes and dtype in the payload
  window of the round's compression; every other collective inside the
  round loop (the coverage counts, the int8 scale) carries at most
  ``PARAM_SLACK`` bytes;
* under ``hierarchy``, exactly one param-sized all-reduce over the pod
  dimension per exchange window (``num_rounds / period`` of them), in
  the window of the exchange's own compression;
* the batch engine with a mesh runs nothing inside the round loop
  (one gather of the result rows after it);
* the 2-D engine runs exactly ONE all-reduce over the data dimension per
  round, of its model shard's d/n_model floats (the int8 window under
  compression; none on the K2 path, where one data rank holds every
  worker), one pod all-reduce of d floats a window under ``hierarchy``,
  model-dimension collectives of at most d floats in the loop, and, for
  dense curvature, init collectives of at most two (d/n_model, d)
  panels.  Its memory contract (``memory_ceiling``, checked by
  ``analysis.memory.LargestTensors``): no tensor the dense run makes is
  larger than one panel plus ``MEMORY_SLACK``.

The deep-net train step with a mesh (``optim.ranl_llm.train_step``,
``train_contract``) runs, each step, exactly ONE all-reduce over the
worker plane ("data", or "pod+data"), whose bytes are one f32 pass over
this rank's params shard (two under ``precond_beta``) plus at most
``TRAIN_SMALL`` bytes (the N losses and per-leaf sums) — the reference's
``grad_bytes`` window; with M > 1 model shards, exactly one all-gather
of the params' cut leaves over "model" and one small all-reduce over
"model" (the Newton step's per-leaf ‖Δ‖² and the grad norm); nothing
else.  Its init runs one more plane pass (the Fisher diagonal) and,
with M > 1, one all-gather.

Two more derivations serve the run journal (``obs``): ``contract_key``
names an engine x options combination as the reference's registry does,
and ``round_byte_budget`` gives the per-round ceilings of the metered
``comm_bytes`` and ``pod_bytes`` traces that the drift alarm
(``obs.metrics.check_byte_drift``) holds each round to.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

PARAM_SLACK = 256        # bytes: the ceiling of a "small" collective
COMPRESSED_SLACK = 64    # bytes of side-band a compressed payload may add
MEMORY_SLACK = 64 * 1024  # bytes a tensor may exceed the panel by
TRAIN_SMALL = 64 * 1024   # bytes of small sums a train step's pass carries


@dataclass(frozen=True)
class Budget:
    """Exactly one collective ``op`` (an all-reduce ``"sum"`` unless
    said) over ``dim`` in each of ``units`` units of ``period`` rounds, of
    ``min_bytes`` … ``max_bytes`` bytes and a dtype among ``dtypes``.  As
    an ``init_budgets`` entry: exactly ``units`` of them outside the
    loop."""
    dim: str
    period: int
    units: int
    min_bytes: int
    max_bytes: int
    dtypes: tuple[str, ...]
    op: str = "sum"

    def matches(self, rec) -> bool:
        return (rec.dim == self.dim and rec.op == self.op
                and rec.dtype in self.dtypes
                and self.min_bytes <= rec.nbytes <= self.max_bytes)


@dataclass(frozen=True)
class CommContract:
    """``budgets``: the param-sized collectives of the round loop;
    ``caps``: (dim, max bytes) of the other in-loop collectives over that
    dimension, any number of them; ``small_max_bytes``: the ceiling of
    every other in-loop collective (0: none may run in the loop);
    ``outside``: whether collectives may run outside the loop, each of at
    most ``outside_max_bytes`` (None: any size); ``init_budgets``, when
    given, the only collectives allowed outside the loop."""
    rounds: int
    budgets: tuple[Budget, ...] = ()
    small_max_bytes: int = 0
    outside: bool = False
    caps: tuple[tuple[str, int], ...] = ()
    outside_max_bytes: int | None = None
    init_budgets: tuple[Budget, ...] = ()


def _payload_window(comp, nbytes_f32: int):
    """(min, max, dtypes) of the wire tensor of a param-sized payload of
    ``nbytes_f32`` uncompressed bytes under ``comp`` (a
    ``CompressionSpec``, or the bare kind string of a hierarchy's
    exchange).  int8 sends a byte a coordinate; bf16 and top-k send f32
    (``core.compression.psum_compressed``)."""
    kind = getattr(comp, "kind", comp)
    if kind == "int8":
        n = nbytes_f32 // 4
        return n, n + COMPRESSED_SLACK + PARAM_SLACK, ("int8",)
    return nbytes_f32, nbytes_f32 + PARAM_SLACK, ("float32",)


def engine_contract(engine: str, opts, *, dim: int, mesh=None,
                    data_axis: str = "data", pod_axis: str = "pod",
                    model_axis: str = "model", n_data: int = 1,
                    n_model: int = 1) -> CommContract:
    """The contract of ``engine`` run with ``opts`` on a ``dim``-wide
    problem (``mesh``: the run's ``DeviceMesh``, or None; ``n_data`` and
    ``n_model``: the 2-D mesh's extents)."""
    T = int(opts.num_rounds)
    if engine in ("scan", "reference") or (engine == "batch"
                                            and mesh is None):
        return CommContract(rounds=T)
    if engine == "batch":
        return CommContract(rounds=T, outside=True)
    if engine == "sharded2d":
        return _contract_2d(opts, T, dim=dim, n_data=n_data,
                            n_model=n_model, data_axis=data_axis,
                            pod_axis=pod_axis, model_axis=model_axis)
    if engine != "sharded":
        raise ValueError(f"no contract for engine {engine!r}")
    lo, hi, dts = _payload_window(opts.compression_spec(), dim * 4)
    budgets = [Budget(dim=data_axis, period=1, units=T, min_bytes=lo,
                      max_bytes=hi, dtypes=dts)]
    hspec = opts.hierarchy_spec()
    if hspec is not None:
        lo, hi, dts = _payload_window(hspec.compression, dim * 4)
        budgets.append(Budget(dim=pod_axis, period=hspec.period,
                              units=T // hspec.period, min_bytes=lo,
                              max_bytes=hi, dtypes=dts))
    return CommContract(rounds=T, budgets=tuple(budgets),
                        small_max_bytes=PARAM_SLACK, outside=True)


def _contract_2d(opts, T: int, *, dim: int, n_data: int, n_model: int,
                 data_axis: str, pod_axis: str,
                 model_axis: str) -> CommContract:
    p = dim // n_model
    comp, hspec = opts.compression_spec(), opts.hierarchy_spec()
    fused = (opts.use_kernel and opts.curvature == "diag" and n_data == 1
             and opts.quorum_spec() is None and comp is None
             and hspec is None)
    budgets = []
    if not fused:
        lo, hi, dts = _payload_window(comp, p * 4)
        budgets.append(Budget(dim=data_axis, period=1, units=T,
                              min_bytes=lo, max_bytes=hi, dtypes=dts))
    outside_max = PARAM_SLACK      # overlap samples round 1 before the loop
    if opts.curvature == "dense":
        outside_max = 2 * p * dim * 4            # the init: two panels
    if hspec is not None:
        lo, hi, dts = _payload_window(hspec.compression, dim * 4)
        budgets.append(Budget(dim=pod_axis, period=hspec.period,
                              units=T // hspec.period, min_bytes=lo,
                              max_bytes=hi, dtypes=dts))
        # the pods' iterates, gathered after the loop
        outside_max = max(outside_max, (T + 2) * dim * 4)
    return CommContract(rounds=T, budgets=tuple(budgets),
                        small_max_bytes=PARAM_SLACK,
                        caps=((model_axis, dim * 4),),
                        outside=True, outside_max_bytes=outside_max)


def train_contract(steps: int, *, shard_numel: int, plane: str = "data",
                   n_model: int = 1, gather_bytes: int = 0,
                   precond_beta: float = 0.0) -> CommContract:
    """The contract of ``init_state`` then ``steps`` ``train_step``s with
    a mesh (``optim.ranl_llm.mesh_sizes`` gives ``shard_numel``, the
    elements of this rank's params shard, ``plane``, the worker plane's
    name in the log, ``n_model`` and ``gather_bytes``, the bytes of the
    cut leaves an all-gather over "model" sends)."""
    passes = 2 if precond_beta > 0.0 else 1

    def pass_of(n, units):
        return Budget(dim=plane, period=1, units=units, min_bytes=4 * n,
                      max_bytes=4 * n + TRAIN_SMALL, dtypes=("float32",))
    gather = Budget(dim="model", period=1, units=steps,
                    min_bytes=gather_bytes,
                    max_bytes=gather_bytes + TRAIN_SMALL, dtypes=("uint8",),
                    op="all_gather")
    budgets = [pass_of(passes * shard_numel, steps)]
    init = [pass_of(shard_numel, 1)]
    if n_model > 1:
        budgets += [gather, Budget(dim="model", period=1, units=steps,
                                   min_bytes=4, max_bytes=TRAIN_SMALL,
                                   dtypes=("float32",))]
        init.append(dataclasses.replace(gather, units=1))
    return CommContract(rounds=steps, budgets=tuple(budgets), outside=True,
                        init_budgets=tuple(init))


def memory_ceiling(engine: str, opts, *, dim: int,
                   n_model: int = 1) -> int | None:
    """The largest tensor, in bytes, a run may make: for the 2-D
    engine's dense curvature one (dim/n_model, dim) f32 panel plus
    ``MEMORY_SLACK``; None where no ceiling is promised."""
    if engine == "sharded2d" and opts.curvature == "dense":
        return (dim // n_model) * dim * 4 + MEMORY_SLACK
    return None


def check_log(contract: CommContract, log) -> dict:
    """Hold a collective log to ``contract``.  Returns ``{"ok": bool,
    "violations": [...], "counts": {...}}``: ``counts`` has, per budget,
    the matches per unit, and the numbers of small in-loop and of
    outside-the-loop collectives."""
    bad = []
    matched = [[0] * b.units for b in contract.budgets]
    at_init = [0] * len(contract.init_budgets)
    caps = dict(contract.caps)
    small = capped = outside = 0
    for rec in log:
        if rec.round is None:
            outside += 1
            hit = next((i for i, b in enumerate(contract.init_budgets)
                        if b.matches(rec)), None)
            if hit is not None:
                at_init[hit] += 1
            elif not contract.outside or contract.init_budgets:
                bad.append(f"collective outside the loop: {rec}")
            elif (contract.outside_max_bytes is not None
                  and rec.nbytes > contract.outside_max_bytes):
                bad.append(f"collective outside the loop over "
                           f"{contract.outside_max_bytes} bytes: {rec}")
            continue
        if not 1 <= rec.round <= contract.rounds:
            bad.append(f"collective in round {rec.round} of "
                       f"{contract.rounds}: {rec}")
            continue
        for i, b in enumerate(contract.budgets):
            if b.matches(rec):
                unit = (rec.round - 1) // b.period
                if unit < b.units:
                    matched[i][unit] += 1
                    break
        else:
            if rec.dim in caps:
                capped += 1
                ceiling = caps[rec.dim]
            else:
                small += 1
                ceiling = contract.small_max_bytes
            if rec.nbytes > ceiling:
                bad.append(f"in-loop collective over {ceiling} bytes: "
                           f"{rec}")
    for b, per_unit in zip(contract.budgets, matched):
        for unit, n in enumerate(per_unit):
            if n != 1:
                bad.append(f"{n} param-sized all-reduces over {b.dim!r} "
                           f"in unit {unit} ({b.period} round(s)), "
                           f"expected 1")
    for b, n in zip(contract.init_budgets, at_init):
        if n != b.units:
            bad.append(f"{n} {b.op} over {b.dim!r} outside the loop, "
                       f"expected {b.units}")
    counts = {f"{b.dim}/{b.period}"
              + ("" if b.op == "sum" else f"/{b.op}"): per_unit
              for b, per_unit in zip(contract.budgets, matched)}
    counts.update(small_in_loop=small, capped_in_loop=capped,
                  outside_loop=outside)
    return {"ok": not bad, "violations": bad, "counts": counts}


def contract_key(engine: str, opts) -> str:
    """The reference registry's key for an engine x options combination
    (the journal header's ``contract_key``)."""
    comp = opts.compression_spec()
    parts = [
        engine,
        f"comp={comp.kind if comp is not None else 'none'}",
        f"quorum={'on' if opts.quorum_spec() is not None else 'off'}",
        f"overlap={'on' if opts.overlap else 'off'}",
        f"rank={opts.hessian_rank if opts.hessian_rank else 'none'}",
    ]
    hspec = opts.hierarchy_spec()
    if hspec is not None:
        tag = f"hier=p{hspec.pods}k{hspec.period}"
        if hspec.compression is not None:
            tag += f"-{hspec.compression}"
        parts.append(tag)
    return "|".join(parts)


def _hier_window(kind: str | None, nbytes_f32: int):
    """(min, max, dtypes) of the reference's inter-pod exchange window for
    an ``nbytes_f32``-byte payload under the bare compression ``kind``
    (its bf16 window is two bytes a coordinate, the dtype the reference
    reduces in)."""
    if kind == "int8":
        n = nbytes_f32 // 4
        return n, n + COMPRESSED_SLACK + PARAM_SLACK, ("int8",)
    if kind == "bf16":
        n = nbytes_f32 // 2
        return n, n + PARAM_SLACK, ("bfloat16",)
    return nbytes_f32, nbytes_f32 + PARAM_SLACK, ("float32",)


def round_byte_budget(opts, *, dim: int, num_workers: int) -> dict:
    """Per-round ceilings of the two metered wire traces, as the
    reference derives them: ``comm_per_round`` bounds ``comm_bytes`` (the
    per-worker uplinks of a full mask under the ``core.compression`` wire
    model) and ``pod_per_round`` bounds ``pod_bytes`` (one exchange
    payload, or a flat round's crossing on a pod topology).  A round over
    either means the wire model, the compression spec or the engine's
    metering drifted from this derivation."""
    comp = opts.compression_spec()
    if comp is None:
        per_worker = 4.0 * dim
    elif comp.kind == "int8":
        per_worker = dim + COMPRESSED_SLACK     # a byte a coordinate + scale
    elif comp.kind == "bf16":
        per_worker = 2.0 * dim
    else:                                       # top-k: dense f32 + metadata
        per_worker = 4.0 * dim + 4.0 * int(comp.k)
    hspec = opts.hierarchy_spec()
    pod_kind = (hspec.compression if hspec is not None
                else (comp.kind if comp is not None else None))
    if pod_kind not in ("int8", "bf16"):
        pod_kind = None                         # top-k crosses pods dense
    _, pod_hi, _ = _hier_window(pod_kind, dim * 4)
    return {"comm_per_round": per_worker * num_workers,
            "pod_per_round": float(pod_hi)}

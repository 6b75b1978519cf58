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
  (one gather of the result rows after it).
"""

from __future__ import annotations

from dataclasses import dataclass

PARAM_SLACK = 256        # bytes: the ceiling of a "small" collective
COMPRESSED_SLACK = 64    # bytes of side-band a compressed payload may add


@dataclass(frozen=True)
class Budget:
    """Exactly one all-reduce (op sum) over ``dim`` in each of ``units``
    units of ``period`` rounds, of ``min_bytes`` … ``max_bytes`` bytes
    and a dtype among ``dtypes``."""
    dim: str
    period: int
    units: int
    min_bytes: int
    max_bytes: int
    dtypes: tuple[str, ...]


@dataclass(frozen=True)
class CommContract:
    """``budgets``: the param-sized collectives of the round loop;
    ``small_max_bytes``: the ceiling of every other in-loop collective
    (0: none may run in the loop); ``outside``: whether collectives may
    run outside the loop."""
    rounds: int
    budgets: tuple[Budget, ...] = ()
    small_max_bytes: int = 0
    outside: bool = False


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
                    data_axis: str = "data",
                    pod_axis: str = "pod") -> CommContract:
    """The contract of ``engine`` run with ``opts`` on a ``dim``-wide
    problem (``mesh``: the run's ``DeviceMesh``, or None)."""
    T = int(opts.num_rounds)
    if engine in ("scan", "reference") or (engine == "batch"
                                            and mesh is None):
        return CommContract(rounds=T)
    if engine == "batch":
        return CommContract(rounds=T, outside=True)
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


def check_log(contract: CommContract, log) -> dict:
    """Hold a collective log to ``contract``.  Returns ``{"ok": bool,
    "violations": [...], "counts": {...}}``: ``counts`` has, per budget,
    the matches per unit, and the numbers of small in-loop and of
    outside-the-loop collectives."""
    bad = []
    matched = [[0] * b.units for b in contract.budgets]
    small = outside = 0
    for rec in log:
        if rec.round is None:
            outside += 1
            if not contract.outside:
                bad.append(f"collective outside the loop: {rec}")
            continue
        if not 1 <= rec.round <= contract.rounds:
            bad.append(f"collective in round {rec.round} of "
                       f"{contract.rounds}: {rec}")
            continue
        for i, b in enumerate(contract.budgets):
            if (rec.dim == b.dim and rec.op == "sum"
                    and rec.dtype in b.dtypes
                    and b.min_bytes <= rec.nbytes <= b.max_bytes):
                unit = (rec.round - 1) // b.period
                if unit < b.units:
                    matched[i][unit] += 1
                    break
        else:
            small += 1
            if rec.nbytes > contract.small_max_bytes:
                bad.append(f"in-loop collective over "
                           f"{contract.small_max_bytes} bytes: {rec}")
    for b, per_unit in zip(contract.budgets, matched):
        for unit, n in enumerate(per_unit):
            if n != 1:
                bad.append(f"{n} param-sized all-reduces over {b.dim!r} "
                           f"in unit {unit} ({b.period} round(s)), "
                           f"expected 1")
    counts = {f"{b.dim}/{b.period}": per_unit
              for b, per_unit in zip(contract.budgets, matched)}
    counts.update(small_in_loop=small, outside_loop=outside)
    return {"ok": not bad, "violations": bad, "counts": counts}

"""The comparison that decides ``correct``.

The window's training step is the object the set-up drove through its
first rounds: round 0 (the curvature), then ``steps`` rounds, each on
its own batch of the pool.  From that object the set-up reads

* each of those rounds' loss;
* each leaf's ‖h‖, the curvature round 0 derived;
* each leaf's ‖g‖ of round 1's aggregate, worked out from the state
  after it (the gradient memory and the round's masks);
* each leaf's ‖p_steps − p_0‖, before round ``steps + 1`` overwrites it.

The plain reference (``reference.ranl``) computes the same from the same
weights, batches and masks.  The numbers, each a gap:

* ``loss.<t>``: |L_t − L_t,ref| / |L_t,ref| of round t;
* ``curvature``, ``grad``, ``change``: the worst leaf's
  |‖x‖ − ‖x_ref‖| / max(‖x_ref‖, the median leaf's ‖x_ref‖);
* ``<that>.median``, ``<that>.q25``: the median and the lower quartile
  leaf's gap, steadier from seed to seed where rounding is magnified in
  some leaves (RWKV-6's heads normalised by ``ln_x`` magnify it into
  every leaf upstream of them; a lower precision reaches every leaf).

``change`` leaves out the leaves whose reference ``grad`` is under a
thousandth of the median leaf's: they move under the trust ratio by
rounding alone.  A cell's limits file names the numbers it compares and
their limits (``bench/limits/<cell>.json``).
"""

from __future__ import annotations

import math
import statistics

NOUGHT = 1e-3
NORMS = ("curvature", "grad", "change")


def _gap(a: float, b: float, scale: float) -> float:
    g = abs(a - b) / scale
    return g if math.isfinite(g) else math.inf   # a NaN reading fails


def leaf_gaps(got: dict, want: dict) -> dict:
    """{"loss": {round: gap}, and a norm: {leaf: gap}}."""
    out = {"loss": {t: _gap(a, b, abs(b)) for t, (a, b) in
                    enumerate(zip(got["loss"], want["loss"]), start=1)}}
    med = statistics.median(want["grad"].values())
    moving = [k for k, v in want["grad"].items() if v >= NOUGHT * med]
    for name, keys in (("curvature", list(want["curvature"])),
                       ("grad", list(want["grad"])), ("change", moving)):
        m = statistics.median(want[name][k] for k in keys)
        out[name] = {k: _gap(got[name][k], want[name][k],
                             max(want[name][k], m, 1e-30)) for k in keys}
    return out


def gaps(got: dict, want: dict) -> dict:
    """Every number, by name, of the program's readings against the
    reference's (both as ``reference.ranl.run`` returns them)."""
    lg = leaf_gaps(got, want)
    out = {f"loss.{t}": g for t, g in lg["loss"].items()}
    for name in NORMS:
        out[name] = max(lg[name].values())
    for name in NORMS:
        v = sorted(lg[name].values())
        out[f"{name}.median"] = statistics.median(v)
        out[f"{name}.q25"] = v[len(v) // 4]
    return out


def judge(values: dict, limits: dict | None):
    """(correct, {number: {"value", "limit"}}) over the numbers the
    cell compares: correct when each is finite and within its limit.
    With no limits nothing is compared, and nothing is correct."""
    if not limits:
        return False, {k: {"value": v, "limit": None}
                       for k, v in values.items()}
    checks = {k: {"value": values[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks

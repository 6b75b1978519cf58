"""`RanlOptions` — the one frozen, hashable options record every engine takes.

It validates at construction time: a bad ``quorum``, ``record_every`` or
compression spec raises here, in the caller's stack frame.  The record
carries every field of the reference's, so option sets move between the
two packages unchanged; ``repro_torch.run`` rejects the fields whose
engines are still to be ported (see ``repro_torch.api``).
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields, replace

from .compression import parse_compression
from .masks import PolicyConfig


class EngineDeprecationWarning(DeprecationWarning):
    """The warning class of legacy engine entry points.

    Kept so option-handling code reads the same in both packages; the
    port has no legacy entry points, so nothing warns with it yet.
    """


_CURVATURES = ("dense", "diag")
_PROJECTIONS = (None, "eigh", "ns")


@dataclass(frozen=True)
class RanlOptions:
    """Everything an engine run is parameterized by, minus the problem,
    PRNG key, mesh and the heterogeneity objects (controller/cost), which
    stay arguments of ``repro_torch.run``.

    ``projection=None`` means "engine default": the paper-literal ``eigh``
    eigenvalue clamp everywhere it is implementable, and the matmul-only
    Newton–Schulz form on the 2-D dense path (where no device may hold a
    d×d buffer, so ``projection="eigh"`` is a dispatch-time error there).

    Quorum family (``None`` = synchronous, the bit-exact default):

    * ``quorum``: fraction of regions that must be covered by ON-TIME
      workers for the round to commit (the server stops waiting at the
      k-th order statistic of worker times realizing it);
    * ``quorum_tau``: per-region on-time coverage floor — a region counts
      as quorum-covered once ``min(quorum_tau, full coverage)`` of its
      workers are on time.  ``None`` = all of its participating workers;
    * ``gamma``: staleness damping — a contribution arriving ``s`` rounds
      late folds into that later round's aggregate with weight
      ``gamma**s`` (``gamma=0`` drops all late work);
    * ``max_delay``: contributions later than this many rounds are
      dropped outright (and do not refresh the gradient memory).

    Compressed communication (``core.compression``):

    * ``compression``: ``None`` (uncompressed — bit-exact default) |
      ``"int8"`` | ``"bf16"`` | ``"topk:k"`` — lossy uplink compression
      with an error-feedback residual riding the scan carry; metered in
      ``RanlResult.comm_bytes`` and charged by the cost model's uplink
      bandwidth;
    * ``hessian_rank``: fold only the top-r eigenpairs of workers'
      init-phase Hessians into [H]_μ via Cholesky rank-1 updates
      (``None`` = the exact dense init).

    Hierarchical pod-of-pods aggregation (``None`` = flat — bit-exact
    default):

    * ``hierarchy``: ``"pods=P,period=k[,gamma=g][,compression=int8]"``
      — split the worker axis into ``P`` pods.  Intra-pod rounds keep
      the exact data-axis psum unchanged; pods exchange their
      accumulated region-update mass over the ``"pod"`` mesh axis only
      every ``period`` rounds (one pod-axis psum per exchange,
      optionally int8/bf16-compressed with its own error-feedback
      residual), then damp pod iterates toward the exact global
      consensus with weight ``gamma``.  Between exchanges each pod runs
      on remote-pod gradient mass that is up to ``period`` rounds stale
      — the hierarchy's staleness bound.
    """
    num_rounds: int = 30
    num_regions: int = 8
    policy: PolicyConfig = field(default_factory=PolicyConfig)
    mu: float | None = None
    curvature: str = "dense"
    lr: float = 1.0
    use_kernel: bool = True
    hutchinson_samples: int = 8
    projection: str | None = None
    ns_iters: int | str = 60
    record_every: int = 1
    overlap: bool = False
    quorum: float | None = None
    quorum_tau: int | None = None
    gamma: float = 0.5
    max_delay: int = 2
    compression: str | None = None
    hessian_rank: int | None = None
    hierarchy: str | None = None

    def __post_init__(self):
        if not isinstance(self.policy, PolicyConfig):
            raise TypeError(f"policy must be a PolicyConfig, got "
                            f"{self.policy!r}")
        if self.curvature not in _CURVATURES:
            raise ValueError(f"unknown curvature {self.curvature!r} "
                             f"(expected one of {_CURVATURES})")
        if self.projection not in _PROJECTIONS:
            raise ValueError(f"unknown projection {self.projection!r} "
                             f"(expected None, 'eigh' or 'ns')")
        if self.num_regions < 1:
            raise ValueError(f"num_regions={self.num_regions} must be >= 1")
        if self.ns_iters != "auto" and int(self.ns_iters) < 1:
            raise ValueError(f"ns_iters={self.ns_iters!r} must be 'auto' "
                             f"or a positive int")
        if self.record_every < 1:
            raise ValueError(
                f"record_every={self.record_every} must be >= 1")
        if self.hutchinson_samples < 1:
            raise ValueError(f"hutchinson_samples="
                             f"{self.hutchinson_samples} must be >= 1")
        if self.quorum is not None and not 0.0 < self.quorum <= 1.0:
            raise ValueError(f"quorum={self.quorum} must be in (0, 1] "
                             f"(or None for synchronous rounds)")
        if self.quorum_tau is not None and self.quorum_tau < 1:
            raise ValueError(f"quorum_tau={self.quorum_tau} must be >= 1 "
                             f"(or None for full participating coverage)")
        if not 0.0 <= self.gamma <= 1.0:
            raise ValueError(f"gamma={self.gamma} must be in [0, 1]")
        if self.max_delay < 1:
            raise ValueError(f"max_delay={self.max_delay} must be >= 1")
        if self.quorum_tau is not None and self.quorum is None:
            raise ValueError("quorum_tau is set but quorum is None — set "
                             "quorum to enable semi-synchronous rounds")
        parse_compression(self.compression)
        if self.hessian_rank is not None and self.hessian_rank < 1:
            raise ValueError(f"hessian_rank={self.hessian_rank} must be "
                             f">= 1 (or None for the dense init)")
        parse_hierarchy(self.hierarchy)

    def merged(self, **overrides) -> "RanlOptions":
        """A copy with ``overrides`` applied (unknown keys raise)."""
        known = {f.name for f in fields(self)}
        bad = set(overrides) - known
        if bad:
            raise TypeError(f"unknown RanlOptions field(s) "
                            f"{sorted(bad)} (known: {sorted(known)})")
        return replace(self, **overrides)

    def quorum_spec(self) -> "QuorumSpec | None":
        return (None if self.quorum is None else
                QuorumSpec(quorum=float(self.quorum),
                           quorum_tau=self.quorum_tau,
                           gamma=float(self.gamma),
                           max_delay=int(self.max_delay)))

    def compression_spec(self):
        """-> ``core.compression.CompressionSpec | None`` (the static
        record the engines branch on; ``None`` = uncompressed)."""
        return parse_compression(self.compression)

    def hierarchy_spec(self) -> "HierarchySpec | None":
        """-> :class:`HierarchySpec` | None (``None`` = flat — the
        engines compile the historical computation unchanged)."""
        return parse_hierarchy(self.hierarchy)


@dataclass(frozen=True)
class HierarchySpec:
    """The static pod-of-pods parameters the compiled round loops branch
    on (``None`` in ``RanlOptions.hierarchy`` means no such record and
    the flat engines compile bit-exact).

    * ``pods``: number of pods the worker axis splits into (``pods=1``
      degenerates to a flat run with the hierarchical bookkeeping —
      parity-tested against the flat engines);
    * ``period``: rounds between inter-pod exchanges; also the
      hierarchy's staleness bound (remote-pod mass is at most ``period``
      rounds old).  ``num_rounds % period == 0`` is checked at dispatch;
    * ``gamma``: consensus damping — pod iterates move
      ``x_p += gamma * (x̄ - x_p)`` at each exchange (``gamma=1``
      snaps every pod to the exact global consensus iterate);
    * ``compression``: ``None`` | ``"int8"`` | ``"bf16"`` — compress
      the inter-pod exchange payload (its error-feedback residual rides
      the outer scan carry; ``topk`` is intra-pod-only and rejected).
    """
    pods: int = 2
    period: int = 1
    gamma: float = 1.0
    compression: str | None = None


def parse_hierarchy(spec: str | None) -> HierarchySpec | None:
    """``"pods=P,period=k[,gamma=g][,compression=int8|bf16]"`` ->
    :class:`HierarchySpec` (``None``/empty -> ``None``)."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, HierarchySpec):
        return spec
    params = {}
    for item in str(spec).split(","):
        k, sep, v = item.partition("=")
        if not sep or not k.strip():
            raise ValueError(f"bad hierarchy item {item!r} in {spec!r} "
                             f"(expected key=value)")
        params[k.strip()] = v.strip()
    unknown = set(params) - {"pods", "period", "gamma", "compression"}
    if unknown:
        raise ValueError(f"unknown hierarchy key(s) {sorted(unknown)} in "
                         f"{spec!r} (known: pods, period, gamma, "
                         f"compression)")
    if "pods" not in params:
        raise ValueError(f"hierarchy={spec!r} must set pods=P")
    pods = int(params["pods"])
    period = int(params.get("period", 1))
    gamma = float(params.get("gamma", 1.0))
    comp = params.get("compression") or None
    if pods < 1:
        raise ValueError(f"hierarchy pods={pods} must be >= 1")
    if period < 1:
        raise ValueError(f"hierarchy period={period} must be >= 1")
    if not 0.0 < gamma <= 1.0:
        raise ValueError(f"hierarchy gamma={gamma} must be in (0, 1]")
    if comp is not None and comp not in ("int8", "bf16"):
        raise ValueError(f"hierarchy compression={comp!r} must be None, "
                         f"'int8' or 'bf16' (topk is intra-pod only)")
    return HierarchySpec(pods=pods, period=period, gamma=gamma,
                         compression=comp)


@dataclass(frozen=True)
class QuorumSpec:
    """The static quorum parameters the compiled round loops branch on.

    Separate from ``RanlOptions`` so the engine internals hash/trace on
    exactly the four scalars they use (``None`` = fully synchronous —
    the engines compile the historical computation unchanged).
    """
    quorum: float = 1.0
    quorum_tau: int | None = None
    gamma: float = 0.5
    max_delay: int = 2

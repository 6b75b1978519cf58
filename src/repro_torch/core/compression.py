"""Uplink compression: the option parser and the wire-byte model.

This slice carries the uncompressed path only.  ``parse_compression``
validates ``RanlOptions.compression`` at construction time (same grammar
and errors as the reference), and ``uplink_bytes`` meters the
uncompressed wire.  The lossy compressors, their error-feedback residual
and the compressed aggregations arrive with ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_KINDS = ("int8", "bf16", "topk")


@dataclass(frozen=True)
class CompressionSpec:
    """Static compressor parameters: ``kind`` is ``"int8"``, ``"bf16"``
    or ``"topk"`` (keep the ``k`` highest-energy regions)."""
    kind: str
    k: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown compression kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if self.kind == "topk" and self.k < 1:
            raise ValueError(f"topk compression needs k >= 1, got "
                             f"k={self.k}")


def parse_compression(value) -> CompressionSpec | None:
    """``None | "int8" | "bf16" | "topk:k"`` -> CompressionSpec | None."""
    if value is None or isinstance(value, CompressionSpec):
        return value
    s = str(value)
    if s in ("int8", "bf16"):
        return CompressionSpec(kind=s)
    if s.startswith("topk:"):
        try:
            k = int(s.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"compression={value!r}: top-k count must "
                             f"be an int (e.g. 'topk:2')") from None
        return CompressionSpec(kind="topk", k=k)
    raise ValueError(f"compression={value!r} must be None, 'int8', "
                     f"'bf16' or 'topk:k'")


def uplink_bytes(comp: CompressionSpec | None, M: torch.Tensor,
                 sizes_q: torch.Tensor) -> torch.Tensor:
    """(N,) f32 modeled uplink bytes per worker for one round's (N, Q)
    mask: 4 bytes per trained coordinate uncompressed."""
    if comp is not None:
        raise NotImplementedError(
            "compressed uplinks arrive with ROADMAP Queue 1 item 9")
    kept = M.to(torch.float32) * sizes_q[None, :].to(torch.float32)
    return 4.0 * kept.sum(dim=1)

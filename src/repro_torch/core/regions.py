"""Region partition of the parameter vector (paper: Q regions of x ∈ R^d)."""

from __future__ import annotations

import numpy as np
import torch


def contiguous_regions(d: int, num_regions: int, device) -> torch.Tensor:
    """Region id per coordinate: (d,) int64 with values in [0, Q).

    Contiguous blocks, sizes as equal as possible (the reference's
    ``linspace`` bounds)."""
    if not 1 <= num_regions <= d:
        raise ValueError(f"need 1 <= Q <= d, got Q={num_regions}, d={d}")
    bounds = np.linspace(0, d, num_regions + 1).astype(np.int64)
    ids = np.zeros(d, np.int64)
    for q in range(num_regions):
        ids[bounds[q]:bounds[q + 1]] = q
    return torch.as_tensor(ids, device=device)


def expand_mask(region_mask: torch.Tensor, region_ids: torch.Tensor):
    """(..., Q) region mask -> (..., d) coordinate mask."""
    return region_mask.index_select(-1, region_ids)


def region_sizes(region_ids: torch.Tensor, num_regions: int) -> torch.Tensor:
    """(Q,) int32 coordinates per region."""
    return torch.bincount(region_ids, minlength=num_regions).to(torch.int32)

"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` -> the CUDA card (raises when there is none); anything
    else is taken as given, so ``device="cpu"`` is the explicit opt-in
    for running on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host")
        return torch.device("cuda")
    return torch.device(device)

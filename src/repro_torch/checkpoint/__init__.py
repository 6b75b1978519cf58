"""Checkpoints in the reference's layout (``save`` / ``restore``)."""

from .checkpoint import restore, save  # noqa: F401

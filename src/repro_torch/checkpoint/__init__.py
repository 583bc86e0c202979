"""Checkpointing with atomic commits and restore onto any device."""

from .manager import CheckpointManager

__all__ = ["CheckpointManager"]

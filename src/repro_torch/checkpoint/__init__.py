"""Checkpoint/restart of the train state."""

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401

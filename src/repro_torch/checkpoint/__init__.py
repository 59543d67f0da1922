"""Checkpoints of the port, in the reference's on-disk layout (``repro/checkpoint``)."""
from repro_torch.checkpoint.checkpoint import committed_steps, latest_step, restore, save

__all__ = ["committed_steps", "latest_step", "restore", "save"]

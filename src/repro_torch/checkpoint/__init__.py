"""Checkpoints of the port (counterpart of `repro.checkpoint`), in the
reference's on-disk format."""
from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["ckpt", "CheckpointManager"]

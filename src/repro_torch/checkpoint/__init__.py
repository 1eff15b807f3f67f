"""Checkpoints in the reference's layout (counterpart of
``src/repro/checkpoint``)."""
from .store import (CheckpointManager, load_checkpoint, reshard_tree,
                    save_checkpoint)

__all__ = ["CheckpointManager", "load_checkpoint", "reshard_tree",
           "save_checkpoint"]

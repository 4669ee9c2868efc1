"""Atomic, sharded, async checkpoints (counterpart of
``repro.checkpoint``; the same on-disk format)."""

from repro_torch.checkpoint.manager import (CheckpointManager,
                                            ShardedTensor, latest_step,
                                            load_manifest,
                                            restore_checkpoint,
                                            save_checkpoint)

__all__ = ["CheckpointManager", "ShardedTensor", "latest_step",
           "load_manifest", "restore_checkpoint", "save_checkpoint"]

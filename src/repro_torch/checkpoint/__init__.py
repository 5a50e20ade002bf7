"""Checkpoints on the reference's layout, with async save."""
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer,
                                               latest_step,
                                               restore_checkpoint,
                                               save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint", "AsyncCheckpointer",
           "latest_step"]

"""Checkpointing: the reference's on-disk format, for the port's trees."""

from repro_torch.checkpoint.ckpt import (AsyncCheckpointer,
                                         CheckpointError, checkpoint_bytes,
                                         latest_checkpoint, load_checkpoint,
                                         load_checkpoint_arrays,
                                         read_manifest, save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "load_checkpoint_arrays",
           "AsyncCheckpointer", "CheckpointError", "latest_checkpoint",
           "checkpoint_bytes", "read_manifest"]

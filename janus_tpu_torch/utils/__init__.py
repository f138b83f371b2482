"""Utilities: training checkpoints."""

from janus_tpu_torch.utils.checkpoint import (restore_checkpoint,
                                              save_checkpoint)

__all__ = ["save_checkpoint", "restore_checkpoint"]

"""Checkpoints (atomic, versioned, keep-last-k, resumable) and elastic
full-batch rescaling. `elastic` pulls the trainers: import it as a
submodule (`from repro_torch.ckpt import elastic`) where it is needed."""

from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager,
    checkpoint_extra,
    restore_latest,
    save_checkpoint,
    tree_nbytes,
)

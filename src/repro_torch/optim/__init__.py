"""Optimizers as pure functions on parameter trees (nested dicts and
lists of tensors): Adam, SGD-momentum and global-norm clipping."""

from repro_torch.optim.adam import (
    AdamState,
    SGDState,
    adam_init,
    adam_step,
    adam_update,
    clip_by_global_norm,
    leaves,
    sgd_init,
    sgd_update,
    tree_map,
)

__all__ = ["AdamState", "SGDState", "adam_init", "adam_step", "adam_update",
           "clip_by_global_norm", "leaves", "sgd_init", "sgd_update",
           "tree_map"]

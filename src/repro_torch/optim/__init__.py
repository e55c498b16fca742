"""Optimizers as pure functions on the `{"layers": [...]}` parameter dict."""

from repro_torch.optim.adam import (
    AdamState,
    adam_init,
    adam_step,
    adam_update,
    leaves,
    tree_map,
)

__all__ = ["AdamState", "adam_init", "adam_step", "adam_update", "leaves",
           "tree_map"]

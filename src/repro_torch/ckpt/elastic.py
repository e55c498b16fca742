"""Elastic scaling utilities; twin of repro/ckpt/elastic.py.

LM side: `reshard_tree` re-places every leaf of a tree on a device, the
restore step of an elastic restart. GNN side: scaling from k to k'
machines re-partitions the graph (the partition is preprocessing state,
not model state) and rebuilds the device blocks; model parameters transfer
unchanged because they are partition-independent (the tested
distributed==single invariant).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.edge_partition import partition_edges
from repro_torch.core.graph import Graph
from repro_torch.gnn.fullbatch import FullBatchTrainer
from repro_torch.optim import leaves, tree_map


def reshard_tree(tree: Any, placements: Any) -> Any:
    """Place every tensor leaf of `tree` (nested dicts, lists and tuples)
    on the device named by the matching leaf of `placements` (a
    `torch.device` or its name), keeping its dtype. The two trees must
    have the same structure. The reference's twin re-places
    an LM's leaves on a new JAX mesh after an elastic restart; nothing in
    the reference calls it, since its launcher (`repro.dist`) is absent
    from the tree."""
    if isinstance(tree, dict):
        if not isinstance(placements, dict) or set(tree) != set(placements):
            raise ValueError(f"placements do not match the tree's keys "
                             f"{sorted(tree)}")
        return {k: reshard_tree(v, placements[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if (not isinstance(placements, (list, tuple))
                or len(placements) != len(tree)):
            raise ValueError(f"placements do not match a sequence of "
                             f"{len(tree)} leaves")
        return type(tree)(reshard_tree(v, p) for v, p in zip(tree, placements))
    if not isinstance(tree, torch.Tensor):
        raise TypeError(f"reshard_tree: a leaf of type {type(tree).__name__}"
                        "; the leaves are tensors")
    return tree.to(torch.device(placements))


def rescale_fullbatch(
    trainer: FullBatchTrainer,
    graph: Graph,
    new_k: int,
    features: np.ndarray,
    labels: np.ndarray,
    train_mask: np.ndarray,
    *,
    partitioner: str = "hep100",
    seed: int = 0,
) -> FullBatchTrainer:
    """Scale a full-batch GNN trainer from k to new_k machines: re-partition
    the graph, rebuild device blocks on the device the parameters live on,
    carry ALL run state over — model and optimizer (partition-independent),
    the sync mode, the learning rate and wire codec (including the tier a
    VariableRatioCodec's epoch schedule has advanced to, since
    `trainer.codec` holds the advanced instance), and the lossy codec's
    error-feedback carry, re-stacked for the new device count. Reads only
    the trainer's params, opt_state, ef_state, codec, lr, spec, sync_mode
    and book.k: its blocks may already be released."""
    assignment = partition_edges(graph, new_k, partitioner, seed=seed)
    new = FullBatchTrainer.build(
        graph, assignment, new_k, trainer.spec, features, labels, train_mask,
        sync_mode=trainer.sync_mode, seed=seed, lr=trainer.lr,
        codec=trainer.codec, device=leaves(trainer.params)[0].device,
    )
    new.params = trainer.params        # model state is partition-independent
    new.opt_state = trainer.opt_state
    if trainer.ef_state is not None:
        # EF residuals are per-device [k, ...] (unstacked when k == 1): the
        # device mean is the state the gradient all-reduce would have folded
        # in, so replicate it across the new device count
        old_k = trainer.book.k
        mean = (trainer.ef_state if old_k == 1 else
                tree_map(lambda e: e.mean(dim=0), trainer.ef_state))
        new.ef_state = (mean if new_k == 1 else tree_map(
            lambda z: z.expand((new_k,) + z.shape).clone(), mean))
    return new

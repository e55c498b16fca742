"""Elastic scaling of full-batch training; twin of repro/ckpt/elastic.py.

Scaling from k to k' machines re-partitions the graph (the partition is
preprocessing state, not model state) and rebuilds the device blocks;
model parameters transfer unchanged because they are partition-
independent (the tested distributed==single invariant). The reference's
`reshard_tree` (re-placing an LM's leaves on a new JAX mesh) is not
ported: the port has no LM training path (ROADMAP).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.edge_partition import partition_edges
from repro_torch.core.graph import Graph
from repro_torch.gnn.fullbatch import FullBatchTrainer
from repro_torch.optim import leaves, tree_map


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

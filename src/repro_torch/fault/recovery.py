"""Recovery strategies: elastic degrade-and-recover + serving failover.

Twin of repro/fault/recovery.py. Under an installed tracer (obs/trace.py)
a rescale records the `fault.restore`, `fault.repartition` and
`fault.recovery` spans and the `fault.recovery_time_model` counter, and
the first step after it the `fault.recompile` span.

Training (full-batch): `run_elastic_fullbatch` is a supervised driver over
`FullBatchTrainer` that reacts to the plan's `worker-loss` events by
shrinking k -> k-1 (re-partition, rebuild device blocks, carry model +
optimizer + codec state through `ckpt.elastic.rescale_fullbatch`) and to
`worker-join` events by growing back. Model state is partition-
independent (the tested distributed==single invariant), so the rescale is
exact; what it COSTS is the point — every rescale is priced with
`cost_model.recovery_time` (checkpoint restore + re-partition + re-compile)
beside the measured re-partition wall and first step after it. The old
trainer's device blocks are released before the new ones are built, so
the two layouts are never resident together.

Serving: `failover_assignment` re-derives vertex ownership with one worker
dead — the `master_assignment` re-derivation: for an edge partition book,
each vertex mastered on the dead worker moves to the first surviving
partition that holds a REPLICA of it (mirrors already have the data);
vertices with no surviving replica (and all vertices under replica-free
vertex partitions) fall back to a deterministic spread over survivors.
`run_serving_sim` re-routes with this map mid-trace (see serve/engine.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, List

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import tree_nbytes
from repro_torch.core import cost_model
from repro_torch.core.cost_model import PAPER_CLUSTER, ClusterSpec
from repro_torch.core.edge_partition import partition_edges
from repro_torch.obs.trace import get_tracer

__all__ = ["ElasticEvent", "ElasticRunResult", "failover_assignment",
           "run_elastic_fullbatch"]


# ---------------------------------------------------------------------------
# serving failover
# ---------------------------------------------------------------------------


def failover_assignment(owner: np.ndarray, dead: int, k: int, *,
                        book=None) -> np.ndarray:
    """Ownership array with worker `dead` removed.

    `book` (an `EdgePartitionBook`, optional) enables the replica-aware
    re-derivation; without it (vertex partitions hold no replicas) the dead
    worker's vertices spread deterministically over the survivors.
    """
    owner = np.asarray(owner)
    new = owner.copy()
    moved = np.where(owner == dead)[0]
    if moved.size == 0:
        return new
    survivors = np.array([w for w in range(k) if w != dead], dtype=owner.dtype)
    if survivors.size == 0:
        raise ValueError("cannot fail over: no surviving workers")
    fallback = survivors[moved % survivors.size]
    if book is None:
        new[moved] = fallback
        return new
    # replica map: has[p, v] — partition p holds a copy of vertex v
    has = np.zeros((k, owner.shape[0]), dtype=bool)
    for p in range(k):
        ids = book.vglobal[p][book.vmask[p]]
        has[p, ids] = True
    cand = has[survivors][:, moved]            # [k-1, moved]
    replicated = cand.any(axis=0)
    first_replica = survivors[np.argmax(cand, axis=0)]
    new[moved] = np.where(replicated, first_replica, fallback)
    return new


# ---------------------------------------------------------------------------
# elastic full-batch training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ElasticEvent:
    """One executed rescale (shrink or grow)."""

    epoch: int
    action: str                  # "shrink" | "grow"
    old_k: int
    new_k: int
    estimate: Any                # cost_model.RecoveryEstimate
    repartition_s: float         # measured host re-partition + rebuild wall
    compile_s: float = 0.0       # measured first-step wall post-rescale


@dataclasses.dataclass
class ElasticRunResult:
    losses: List[float]
    k_history: List[int]
    events: List[ElasticEvent]
    trainer: Any                 # the final FullBatchTrainer

    @property
    def recovery_estimates(self) -> list:
        return [e.estimate for e in self.events]

    @property
    def recovery_time_total(self) -> float:
        return float(sum(e.estimate.recovery_time for e in self.events))


def _state_bytes(trainer) -> int:
    """Checkpointable state volume: what a restore must read back."""
    tree = {"params": trainer.params, "opt_state": trainer.opt_state}
    if trainer.ef_state is not None:
        tree["ef"] = trainer.ef_state
    return tree_nbytes(tree)


def _rescale(trainer, new_k: int, epoch: int, action: str, graph, features,
             labels, train_mask, *, partitioner: str, seed: int,
             cluster: ClusterSpec) -> tuple:
    from repro_torch.ckpt.elastic import rescale_fullbatch

    tracer = get_tracer()
    t_rec0 = time.perf_counter() if tracer.enabled else 0.0
    # restore phase: the state a real peer would read from the checkpoint,
    # priced from its bytes
    with (tracer.span("fault.restore", cat="fault",
                      args={"epoch": epoch, "action": action})
          if tracer.enabled else contextlib.nullcontext()):
        ckpt_bytes = _state_bytes(trainer)
    old_k = trainer.book.k
    # the old layout is dead: release its device blocks before the new ones
    # are built (the rescale reads only the run state)
    trainer.blocks = None
    trainer.__dict__.pop("_step_fns", None)
    with tracer.span("fault.repartition", cat="fault",
                     args={"old_k": old_k, "new_k": new_k}) as sp:
        new = rescale_fullbatch(
            trainer, graph, new_k, features, labels, train_mask,
            partitioner=partitioner, seed=seed)
    repartition_s = sp.duration
    est = cost_model.recovery_time(ckpt_bytes, repartition_s, cluster=cluster)
    tracer.add("fault.recovery_time_model", est.recovery_time)
    if tracer.enabled:
        tracer.record_span(
            "fault.recovery", t_rec0, time.perf_counter(), cat="fault",
            args={"epoch": epoch, "action": action, "old_k": old_k,
                  "new_k": new_k, "recovery_time_model": est.recovery_time})
    event = ElasticEvent(epoch=epoch, action=action, old_k=old_k,
                         new_k=new_k, estimate=est,
                         repartition_s=repartition_s)
    return new, event


def run_elastic_fullbatch(
    graph,
    features: np.ndarray,
    labels: np.ndarray,
    train_mask: np.ndarray,
    spec,
    *,
    k: int,
    epochs: int,
    device: torch.device,
    plan=None,
    partitioner: str = "hep100",
    seed: int = 0,
    sync_mode: str = "halo",
    codec=None,
    lr: float = 1e-2,
    cluster: ClusterSpec = PAPER_CLUSTER,
) -> ElasticRunResult:
    """Train full-batch for `epochs` on `device`, executing the plan's
    worker-loss / worker-join events: shrink to k-1 when a worker dies,
    grow back toward the original k when one rejoins. Returns the loss
    trajectory, the k in effect at every epoch, and one priced
    `ElasticEvent` per rescale."""
    from repro_torch.gnn.fullbatch import FullBatchTrainer

    tracer = get_tracer()
    assignment = partition_edges(graph, k, partitioner, seed=seed)
    trainer = FullBatchTrainer.build(
        graph, assignment, k, spec, features, labels, train_mask,
        sync_mode=sync_mode, seed=seed, lr=lr, codec=codec, device=device)
    base_k = k
    losses: List[float] = []
    k_history: List[int] = []
    events: List[ElasticEvent] = []
    just_rescaled = False
    for epoch in range(epochs):
        if plan is not None:
            for ev in plan.pending("worker-loss", epoch=epoch):
                cur_k = trainer.book.k
                if cur_k <= 1:
                    continue  # nothing left to lose a worker from
                lost = plan.resolve_worker(ev, cur_k)
                if plan.fire(ev, epoch=epoch, worker=lost):
                    trainer, event = _rescale(
                        trainer, cur_k - 1, epoch, "shrink", graph, features,
                        labels, train_mask, partitioner=partitioner,
                        seed=seed, cluster=cluster)
                    events.append(event)
                    plan.mark_handled(ev)
                    just_rescaled = True
            for ev in plan.pending("worker-join", epoch=epoch):
                cur_k = trainer.book.k
                if cur_k >= base_k:
                    continue  # already at full strength
                if plan.fire(ev, epoch=epoch):
                    trainer, event = _rescale(
                        trainer, cur_k + 1, epoch, "grow", graph, features,
                        labels, train_mask, partitioner=partitioner,
                        seed=seed, cluster=cluster)
                    events.append(event)
                    plan.mark_handled(ev)
                    just_rescaled = True
        trainer.set_epoch(epoch)
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step()))
        t1 = time.perf_counter()
        if just_rescaled:
            # the first step after a rescale runs on the new layout's
            # shapes for the first time; record it against the estimate's
            # re-compile term
            if tracer.enabled:
                tracer.record_span("fault.recompile", t0, t1, cat="fault",
                                   args={"epoch": epoch,
                                         "k": trainer.book.k})
            events[-1].compile_s = t1 - t0
            just_rescaled = False
        k_history.append(trainer.book.k)
    return ElasticRunResult(losses=losses, k_history=k_history,
                            events=events, trainer=trainer)

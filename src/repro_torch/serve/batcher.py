# Copy of repro/serve/batcher.py (NumPy only), imports redirected to repro_torch;
# tests/test_torch_host.py holds its results equal to the original.
"""Micro-batching of target-vertex requests into padded MFGs.

An online GNN service answers "embed/classify vertex v" requests. Per-request
MFG construction would leave the device idle and recompile per shape;
production servers (and LM serving — see launch/serve.py's batched decode)
instead coalesce requests into micro-batches. Two properties matter here:

  * **static shapes**: every micro-batch is padded to one `SamplePlan`
    (`sampling.LayerPad`), whatever the request mix — 1 request or
    `max_batch`, duplicates or hubs — so the serve step compiles exactly
    once. `build_mfg` is the invariant's home (tested directly).
  * **bounded wait**: a batch dispatches when full OR when its oldest
    request has waited `max_wait` — the classic latency/throughput knob
    (`plan_dispatch` implements the policy as a pure function of arrival
    times so the simulator and tests share it).

The batcher is per-worker: requests are routed to the embedding store's
owner partition, where the target's rows (and most of its neighborhood,
if the partitioner did its job) live locally.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.gnn.sampling import SamplePlan, SampledBatch, sample_blocks

__all__ = ["MicroBatch", "MicroBatcher", "plan_dispatch"]


class MicroBatch(NamedTuple):
    """One dispatched micro-batch: the padded MFG plus its request bookkeeping."""

    ids: np.ndarray          # [n] requested target vertices (n <= max_batch)
    arrivals: np.ndarray     # [n] request arrival times (seconds)
    dispatch_time: float     # when the batch left the queue
    batch: SampledBatch      # padded to the batcher's static plan


def plan_dispatch(
    arrivals: np.ndarray,
    start: int,
    t_free: float,
    max_batch: int,
    max_wait: float,
) -> tuple[int, float]:
    """Dispatch decision for the queue suffix `arrivals[start:]` (sorted).

    Returns (batch_size, dispatch_time). The worker serves batches serially
    and becomes free at `t_free`; the batch dispatches at the earliest
    moment it is full, OR when the oldest pending request has waited
    `max_wait` — whichever comes first — but never before the worker is
    free (requests that arrive while the worker is busy ride along for
    free, the standard continuous-batching win).
    """
    arrivals = np.asarray(arrivals)
    first = float(arrivals[start])
    t_ready = max(t_free, first)
    # everyone who has arrived by the time the worker could start
    j = int(np.searchsorted(arrivals, t_ready, side="right"))
    if j - start >= max_batch:
        # batch already full: dispatch as soon as its max_batch-th member
        # arrived (possibly earlier than t_ready... but never before t_free)
        return max_batch, max(t_free, float(arrivals[start + max_batch - 1]))
    # not full: hold until the deadline, admitting late arrivals
    deadline = max(t_ready, first + max_wait)
    j = int(np.searchsorted(arrivals, deadline, side="right"))
    if j - start >= max_batch:
        return max_batch, max(t_free, float(arrivals[start + max_batch - 1]))
    return j - start, deadline


@dataclasses.dataclass
class MicroBatcher:
    """Per-worker request coalescer + padded-MFG builder."""

    graph: Graph
    fanouts: tuple
    max_batch: int
    plan: SamplePlan
    owner: Optional[np.ndarray]
    worker: int
    tiled_layout: bool
    max_wait: float
    rng: np.random.Generator
    _labels: np.ndarray = dataclasses.field(default=None, repr=False)

    @classmethod
    def build(
        cls,
        graph: Graph,
        *,
        fanouts: Sequence[int],
        max_batch: int,
        owner: Optional[np.ndarray] = None,
        worker: int = 0,
        tiled_layout: bool = False,
        max_wait: float = 2e-3,
        seed: int = 0,
    ) -> "MicroBatcher":
        fanouts = tuple(int(f) for f in fanouts)
        return cls(
            graph=graph, fanouts=fanouts, max_batch=int(max_batch),
            plan=SamplePlan.build(int(max_batch), fanouts),
            owner=owner, worker=worker, tiled_layout=tiled_layout,
            max_wait=float(max_wait), rng=np.random.default_rng(seed),
            _labels=np.zeros(graph.num_vertices, dtype=np.int32),
        )

    def build_mfg(self, ids: np.ndarray) -> SampledBatch:
        """Pad `ids` (1 <= len <= max_batch, duplicates allowed) to the
        static plan. Every return value has identical array shapes."""
        ids = np.asarray(ids, dtype=np.int64)
        if not 0 < ids.shape[0] <= self.max_batch:
            raise ValueError(
                f"micro-batch size {ids.shape[0]} outside (0, {self.max_batch}]")
        return sample_blocks(
            self.graph, ids, self.fanouts, self.plan, self.rng,
            self._labels, owner=self.owner, worker=self.worker,
            tiled_layout=self.tiled_layout,
        )

    def dispatch(
        self, arrivals: np.ndarray, start: int, t_free: float
    ) -> tuple[int, float]:
        return plan_dispatch(arrivals, start, t_free,
                             self.max_batch, self.max_wait)

"""Distributed layer-wise full-graph GNN inference (the serving substrate).

Twin of repro/gnn/inference.py. Every vertex's layer-l embedding is
computed before any layer-(l+1) embedding, so each layer touches each edge
once. The k edge partitions run stacked on one device (gnn/sync.py), each
layer through `models._LAYERS` (every aggregate through
`kernels.ops.aggregate`), with halo (or dense) completion between
partitions. After
each layer the master rows are gathered into a global [V, d_l] matrix on
the host; `build_embedding_stores` freezes those into `RowStore`s, which
the online path (`repro_torch.serve`) answers requests from.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.partition_book import (
    EdgePartitionBook,
    VertexPartitionBook,
    build_edge_book,
)
from repro_torch.gnn import models
from repro_torch.gnn.feature_store import RowStore, select_cache_vertices
from repro_torch.gnn.models import GNNSpec
from repro_torch.gnn.sync import Block, build_blocks, make_sync, sync_bytes_per_round
from repro_torch.obs.trace import get_tracer

__all__ = [
    "LayerwiseInference",
    "build_embedding_stores",
    "edge_assignment_from_vertex",
]


def edge_assignment_from_vertex(graph: Graph, owner: np.ndarray) -> np.ndarray:
    """Edge partition induced by a vertex partition: each edge lives with its
    destination's owner (DistDGL's convention), so the layer-wise engine can
    run over graphs that were partitioned for the mini-batch regime."""
    return np.asarray(owner, dtype=np.int64)[graph.dst]


def _sync_device(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class LayerwiseInference:
    """Compute all layer-l embeddings for every vertex before layer l+1."""

    spec: GNNSpec
    book: EdgePartitionBook
    blocks: Block
    params: Any
    device: torch.device
    sync_mode: str = "halo"
    # measured by the last run(): seconds per layer, host clock around work
    # that ends in a device synchronise
    layer_times: Optional[list] = None

    @classmethod
    def build(
        cls,
        graph: Graph,
        edge_assignment: np.ndarray,
        k: int,
        spec: GNNSpec,
        params: Any,
        features: np.ndarray,
        *,
        device: torch.device,
        sync_mode: str = "halo",
    ) -> "LayerwiseInference":
        book = build_edge_book(
            graph, edge_assignment, k,
            tiled_layout=(spec.agg_backend != "scatter"),
        )
        zeros = np.zeros(graph.num_vertices, dtype=np.int32)
        blocks = build_blocks(book, features.astype(np.float32), zeros,
                              zeros.astype(bool), device=device)
        return cls(spec=spec, book=book, blocks=blocks, params=params,
                   device=device, sync_mode=sync_mode)

    def layer(self, li: int, states: torch.Tensor) -> torch.Tensor:
        """Layer `li` over the stacked [k, n, d] states."""
        mode = "local" if self.book.k == 1 else self.sync_mode
        sync = make_sync(mode, self.blocks)
        h = models._LAYERS[self.spec.model](
            self.params["layers"][li], states, self.blocks, sync,
            final=(li == self.spec.num_layers - 1),
            backend=self.spec.agg_backend)
        # dummy row of every partition must stay zero: padding sink
        h[:, -1] = 0.0
        return h

    @torch.inference_mode()
    def run(self) -> list:
        """Full layer-wise pass. Returns the per-layer global embedding
        matrices [V, d_l] (layer outputs, input-side first; the last entry
        is the final-layer logits)."""
        states = self.blocks.x  # [k, n, F]
        outs: list[np.ndarray] = []
        times: list[float] = []
        tracer = get_tracer()
        for li in range(self.spec.num_layers):
            # layer_times are the span durations — one timing source; the
            # span ends after the device synchronise
            with tracer.span("inference.layer", cat="inference",
                             args={"layer": li}) as sp:
                states = self.layer(li, states)
                _sync_device(self.device)
            times.append(sp.duration)
            outs.append(self.book.scatter_to_global(states.cpu().numpy()))
        self.layer_times = times
        return outs

    def sync_bytes(self) -> int:
        """Analytic sync traffic of one full layer-wise pass (forward only):
        every aggregate priced at its true payload width
        (`GNNSpec.aggregate_dims`)."""
        return sum(
            sync_bytes_per_round(self.book, d, self.sync_mode)
            for layer_dims in self.spec.aggregate_dims(self.sync_mode)
            for d in layer_dims
        )


def build_embedding_stores(
    graph: Graph,
    book: VertexPartitionBook,
    embeddings: list,
    *,
    policy: str = "none",
    budget: int = 0,
    seed: int = 0,
    codec=None,
) -> list:
    """Freeze per-layer embeddings into `RowStore`s sharded by `book`, with
    one cache-vertex selection shared by every layer's store; `codec` is
    the wire codec of their remote-miss rows."""
    ids = select_cache_vertices(graph, book, policy, budget, seed=seed)
    return [
        RowStore.create(book, ids, rows=np.asarray(h, dtype=np.float32),
                        policy=policy, budget=budget, codec=codec)
        for h in embeddings
    ]

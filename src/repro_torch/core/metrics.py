# Copy of repro/core/metrics.py (NumPy only), imports redirected to repro_torch;
# tests/test_torch_host.py holds its results equal to the original.
"""Partitioning-quality metrics, exactly as defined in the paper §2.1.

Edge partitioning (vertex-cut): replication factor RF(P), edge balance EB(P),
vertex balance VB(P).

Vertex partitioning (edge-cut): edge-cut ratio lambda, vertex balance, plus
the paper's GNN-specific metrics (training-vertex balance §5.1, input-vertex
balance §5.2).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph

__all__ = [
    "EdgePartitionMetrics",
    "VertexPartitionMetrics",
    "edge_partition_metrics",
    "vertex_partition_metrics",
    "replication_factor",
]


@dataclasses.dataclass(frozen=True)
class EdgePartitionMetrics:
    num_partitions: int
    replication_factor: float  # RF(P) = (1/|V|) sum_i |V(p_i)|
    edge_balance: float        # max(|p_i|) / mean(|p_i|)
    vertex_balance: float      # max(|V(p_i)|) / mean(|V(p_i)|)
    vertices_per_partition: np.ndarray  # |V(p_i)|, int64 [k]
    edges_per_partition: np.ndarray     # |p_i|,   int64 [k]

    def as_row(self) -> dict:
        return {
            "k": self.num_partitions,
            "rf": round(self.replication_factor, 4),
            "edge_balance": round(self.edge_balance, 4),
            "vertex_balance": round(self.vertex_balance, 4),
        }


@dataclasses.dataclass(frozen=True)
class VertexPartitionMetrics:
    num_partitions: int
    edge_cut: float            # lambda = |E_cut| / |E|
    vertex_balance: float      # max(|p_i|) / mean(|p_i|)
    train_vertex_balance: float  # same over the training-vertex subset
    vertices_per_partition: np.ndarray
    cut_edges: int

    def as_row(self) -> dict:
        return {
            "k": self.num_partitions,
            "edge_cut": round(self.edge_cut, 4),
            "vertex_balance": round(self.vertex_balance, 4),
            "train_vertex_balance": round(self.train_vertex_balance, 4),
        }


def _balance(counts: np.ndarray) -> float:
    counts = np.asarray(counts, dtype=np.float64)
    mean = counts.mean()
    if mean == 0:
        return 1.0
    return float(counts.max() / mean)


def partition_vertex_cover(graph: Graph, edge_assignment: np.ndarray, k: int) -> np.ndarray:
    """|V(p_i)| for each partition: vertices covered by partition i's edges.

    Returns an int64 [k] array. Vectorised: build (partition, vertex) pairs
    for both endpoints, unique them.
    """
    part = np.asarray(edge_assignment, dtype=np.int64)
    pairs_src = part * graph.num_vertices + graph.src.astype(np.int64)
    pairs_dst = part * graph.num_vertices + graph.dst.astype(np.int64)
    uniq = np.unique(np.concatenate([pairs_src, pairs_dst]))
    owners = (uniq // graph.num_vertices).astype(np.int64)
    return np.bincount(owners, minlength=k)


def replication_factor(graph: Graph, edge_assignment: np.ndarray, k: int) -> float:
    cover = partition_vertex_cover(graph, edge_assignment, k)
    # Vertices with degree 0 are not covered anywhere; the paper's RF
    # denominator is |V| of the graph as loaded (all covered in practice).
    covered_any = np.unique(np.concatenate([graph.src, graph.dst])).shape[0]
    denom = max(covered_any, 1)
    return float(cover.sum() / denom)


def edge_partition_metrics(graph: Graph, edge_assignment: np.ndarray, k: int) -> EdgePartitionMetrics:
    assert edge_assignment.shape[0] == graph.num_edges
    assert edge_assignment.min(initial=0) >= 0 and edge_assignment.max(initial=0) < k
    edges_per = np.bincount(edge_assignment, minlength=k).astype(np.int64)
    cover = partition_vertex_cover(graph, edge_assignment, k)
    covered_any = np.unique(np.concatenate([graph.src, graph.dst])).shape[0]
    return EdgePartitionMetrics(
        num_partitions=k,
        replication_factor=float(cover.sum() / max(covered_any, 1)),
        edge_balance=_balance(edges_per),
        vertex_balance=_balance(cover),
        vertices_per_partition=cover,
        edges_per_partition=edges_per,
    )


def vertex_partition_metrics(
    graph: Graph,
    vertex_assignment: np.ndarray,
    k: int,
    train_mask: np.ndarray | None = None,
) -> VertexPartitionMetrics:
    assert vertex_assignment.shape[0] == graph.num_vertices
    assert vertex_assignment.min(initial=0) >= 0 and vertex_assignment.max(initial=0) < k
    per = np.bincount(vertex_assignment, minlength=k).astype(np.int64)
    cut = int((vertex_assignment[graph.src] != vertex_assignment[graph.dst]).sum())
    if train_mask is not None:
        train_per = np.bincount(vertex_assignment[train_mask], minlength=k).astype(np.int64)
        tvb = _balance(train_per)
    else:
        tvb = _balance(per)
    return VertexPartitionMetrics(
        num_partitions=k,
        edge_cut=float(cut / max(graph.num_edges, 1)),
        vertex_balance=_balance(per),
        train_vertex_balance=tvb,
        vertices_per_partition=per,
        cut_edges=cut,
    )


def input_vertex_balance(input_counts: np.ndarray) -> float:
    """Paper §5.2: per-step balance of mini-batch *input vertices* —
    max(input vertices of any worker) / mean(...)."""
    return _balance(input_counts)

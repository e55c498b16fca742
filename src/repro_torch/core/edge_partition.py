# Copy of repro/core/edge_partition.py (NumPy only), imports redirected to repro_torch;
# tests/test_torch_host.py holds its results equal to the original.
"""Edge partitioners (vertex-cut) — the six used in the paper's DistGNN study.

  random  — stateless streaming baseline
  dbh     — Degree-Based Hashing (Xie et al., NIPS'14): hash the
            lower-degree endpoint
  hdrf    — Highest-Degree Replicated First (Petroni et al., CIKM'15):
            stateful streaming, replication+balance score
  2ps-l   — Two-Phase Streaming, linear (Mayer et al., ICDE'22):
            streaming clustering phase + cluster-aware assignment phase
  hep10 / hep100 — Hybrid Edge Partitioner (Mayer & Jacobsen, SIGMOD'21):
            NE++-style in-memory partitioning of low-degree vertices,
            HDRF-style streaming of high-degree ones; tau = 10 / 100

All partitioners return an int32[E] edge→partition assignment. Everything is
deterministic given `seed`. These run on the host (NumPy): partitioning is
preprocessing, not device compute.
"""

from __future__ import annotations

import heapq
from typing import Callable

import numpy as np

from repro_torch.core.graph import Graph

__all__ = ["EDGE_PARTITIONERS", "partition_edges"]


# ---------------------------------------------------------------------------
# Stateless streaming
# ---------------------------------------------------------------------------


def random_edge(graph: Graph, k: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=graph.num_edges, dtype=np.int32)


def dbh(graph: Graph, k: int, seed: int = 0) -> np.ndarray:
    """Assign each edge by hashing its lower-degree endpoint.

    Power-law insight: cutting hubs (replicating high-degree vertices) is
    cheaper in aggregate than cutting low-degree vertices.
    """
    deg = graph.degrees()
    pick_src = deg[graph.src] <= deg[graph.dst]
    chosen = np.where(pick_src, graph.src, graph.dst).astype(np.uint64)
    # Splittable integer hash (fmix64-ish) so assignment isn't id-correlated.
    x = chosen + np.uint64((seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> np.uint64(33)
    x *= np.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> np.uint64(33)
    return (x % np.uint64(k)).astype(np.int32)


# ---------------------------------------------------------------------------
# HDRF — stateful streaming
# ---------------------------------------------------------------------------


def hdrf(graph: Graph, k: int, seed: int = 0, lam: float = 1.0) -> np.ndarray:
    """HDRF: score(e=(u,v), p) = C_rep(u,v,p) + lam * C_bal(p).

    C_rep favours partitions already holding a replica of u or v, weighted so
    the *lower*-degree endpoint pulls harder (replicate hubs first). Uses
    partial (streamed) degrees, as in the original.
    """
    rng = np.random.default_rng(seed)
    order = rng.permutation(graph.num_edges)
    replicas = np.zeros((graph.num_vertices, k), dtype=bool)
    sizes = np.zeros(k, dtype=np.int64)
    pdeg = np.zeros(graph.num_vertices, dtype=np.int64)  # partial degrees
    out = np.empty(graph.num_edges, dtype=np.int32)
    eps = 1.0
    src, dst = graph.src, graph.dst
    for e in order:
        u = int(src[e])
        v = int(dst[e])
        pdeg[u] += 1
        pdeg[v] += 1
        du, dv = pdeg[u], pdeg[v]
        theta_u = du / (du + dv)
        theta_v = 1.0 - theta_u
        g_u = replicas[u] * (2.0 - theta_u)  # 1 + (1 - theta_u)
        g_v = replicas[v] * (2.0 - theta_v)
        maxsize = sizes.max()
        minsize = sizes.min()
        c_bal = (maxsize - sizes) / (eps + maxsize - minsize)
        score = g_u + g_v + lam * c_bal
        p = int(np.argmax(score))
        out[e] = p
        sizes[p] += 1
        replicas[u, p] = True
        replicas[v, p] = True
    return out


# ---------------------------------------------------------------------------
# 2PS-L — two-phase streaming (linear)
# ---------------------------------------------------------------------------


class _UnionFind:
    __slots__ = ("parent", "volume")

    def __init__(self, n: int, volume: np.ndarray):
        self.parent = np.arange(n, dtype=np.int64)
        self.volume = volume.astype(np.int64).copy()

    def find(self, x: int) -> int:
        parent = self.parent
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    def union_into(self, small: int, large: int) -> None:
        self.parent[small] = large
        self.volume[large] += self.volume[small]


def two_ps_l(graph: Graph, k: int, seed: int = 0) -> np.ndarray:
    """2PS-L: (1) streaming clustering by volume-bounded merging,
    (2) map clusters to partitions (largest-first bin packing), then stream
    edges to the partition of the lighter-loaded endpoint cluster.

    Linear run-time; known trade-off (reproduced in the paper): decent
    replication factor but noticeable *vertex imbalance*, because clusters
    are packed whole.
    """
    rng = np.random.default_rng(seed)
    deg = graph.degrees()
    uf = _UnionFind(graph.num_vertices, deg)
    max_vol = max(int(2 * graph.num_edges / k), 1)

    order = rng.permutation(graph.num_edges)
    src, dst = graph.src, graph.dst
    # Phase 1: clustering stream.
    for e in order:
        cu = uf.find(int(src[e]))
        cv = uf.find(int(dst[e]))
        if cu == cv:
            continue
        if uf.volume[cu] > uf.volume[cv]:
            cu, cv = cv, cu  # cu = smaller
        if uf.volume[cu] + uf.volume[cv] <= max_vol:
            uf.union_into(cu, cv)

    roots = np.array([uf.find(i) for i in range(graph.num_vertices)], dtype=np.int64)
    cluster_ids, cluster_of = np.unique(roots, return_inverse=True)
    num_clusters = cluster_ids.shape[0]
    # Cluster edge volume estimate: sum of member degrees / 2.
    cvol = np.zeros(num_clusters, dtype=np.int64)
    np.add.at(cvol, cluster_of, deg)

    # Phase 2a: largest-first packing of clusters onto partitions.
    part_of_cluster = np.empty(num_clusters, dtype=np.int32)
    loads = np.zeros(k, dtype=np.int64)
    for c in np.argsort(-cvol):
        p = int(np.argmin(loads))
        part_of_cluster[c] = p
        loads[p] += cvol[c]

    # Phase 2b: stream edges; intra-cluster edges follow their cluster,
    # inter-cluster edges go to the less-loaded of the two candidates.
    pu = part_of_cluster[cluster_of[src]]
    pv = part_of_cluster[cluster_of[dst]]
    out = np.empty(graph.num_edges, dtype=np.int32)
    edge_loads = np.zeros(k, dtype=np.int64)
    for e in order:
        a, b = int(pu[e]), int(pv[e])
        p = a if (a == b or edge_loads[a] <= edge_loads[b]) else b
        out[e] = p
        edge_loads[p] += 1
    return out


# ---------------------------------------------------------------------------
# HEP — hybrid (NE++ in memory + streaming for high-degree vertices)
# ---------------------------------------------------------------------------


def _neighborhood_expansion(
    graph: Graph,
    eligible_edge: np.ndarray,
    capacity: int,
    k: int,
) -> np.ndarray:
    """NE/NE++ core: grow partitions one at a time, repeatedly absorbing the
    boundary vertex with the fewest *unassigned external* neighbors, so cut
    vertices are minimised. Returns int32[E] with -1 for untouched edges.

    `eligible_edge`: bool[E] mask of edges this phase may assign.
    """
    indptr, indices, eid = _csr_with_eids(graph)
    assigned = np.full(graph.num_edges, -1, dtype=np.int32)
    edge_free = eligible_edge.copy()
    vert_done = np.zeros(graph.num_vertices, dtype=bool)  # in core of some part
    free_deg = np.zeros(graph.num_vertices, dtype=np.int64)
    np.add.at(free_deg, graph.src[eligible_edge], 1)
    np.add.at(free_deg, graph.dst[eligible_edge], 1)

    # Seeds in ascending degree order (NE heuristic: start at the fringe).
    seed_order = iter(np.argsort(free_deg, kind="stable"))

    for p in range(k):
        size = 0
        heap: list[tuple[int, int]] = []  # (ext_estimate, vertex)

        def push_seed() -> bool:
            for s in seed_order:  # noqa: B023 — same iterator across partitions
                s = int(s)
                if not vert_done[s] and free_deg[s] > 0:
                    heapq.heappush(heap, (int(free_deg[s]), s))
                    return True
            return False

        if not push_seed():
            break
        while size < capacity:
            if not heap:
                if not push_seed():
                    break
                continue
            _, x = heapq.heappop(heap)
            if vert_done[x]:
                continue
            vert_done[x] = True
            lo, hi = indptr[x], indptr[x + 1]
            nbrs = indices[lo:hi]
            eids = eid[lo:hi]
            take = edge_free[eids]
            take_eids = eids[take]
            n_take = int(take_eids.shape[0])
            if n_take:
                assigned[take_eids] = p
                edge_free[take_eids] = False
                size += n_take
                touched = nbrs[take]
                np.subtract.at(free_deg, touched, 1)
                free_deg[x] = 0
                for y in touched:
                    y = int(y)
                    if not vert_done[y] and free_deg[y] > 0:
                        heapq.heappush(heap, (int(free_deg[y]), y))
    return assigned


def _csr_with_eids(graph: Graph) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrised CSR that also carries the originating edge id per entry."""
    cached = graph.__dict__.get("_csr_eid")
    if cached is not None:
        return cached
    e = np.arange(graph.num_edges, dtype=np.int64)
    s = np.concatenate([graph.src, graph.dst]).astype(np.int64)
    d = np.concatenate([graph.dst, graph.src]).astype(np.int64)
    ee = np.concatenate([e, e])
    order = np.argsort(s, kind="stable")
    indptr = np.zeros(graph.num_vertices + 1, dtype=np.int64)
    np.cumsum(np.bincount(s[order], minlength=graph.num_vertices), out=indptr[1:])
    out = (indptr, d[order].astype(np.int32), ee[order])
    object.__setattr__(graph, "_csr_eid", out)
    return out


def _hdrf_stream(
    graph: Graph,
    assigned: np.ndarray,
    k: int,
    capacity: int,
    rng: np.random.Generator,
    deg: np.ndarray,
) -> None:
    """HEP's second phase: stream the still-unassigned edges HDRF-style
    (greedy replica/balance score), respecting `capacity`. In-place.

    When every partition is at capacity the capacity-gated score is all
    -inf — `argmax` would then silently dump the edge on partition 0, so we
    fall back to the least-loaded partition instead (capacity is a soft
    balance target, not a hard invariant, once the graph overflows it).
    """
    rest = np.where(assigned < 0)[0]
    if not rest.shape[0]:
        return
    replicas = np.zeros((graph.num_vertices, k), dtype=bool)
    done = assigned >= 0
    np.logical_or.at(replicas, (graph.src[done], assigned[done]), True)
    np.logical_or.at(replicas, (graph.dst[done], assigned[done]), True)
    sizes = np.bincount(assigned[done], minlength=k).astype(np.int64)
    order = rng.permutation(rest)
    src, dst = graph.src, graph.dst
    for e in order:
        u, v = int(src[e]), int(dst[e])
        du, dv = int(deg[u]), int(deg[v])
        theta_u = du / max(du + dv, 1)
        g = replicas[u] * (2.0 - theta_u) + replicas[v] * (1.0 + theta_u)
        has_room = sizes < capacity
        if has_room.any():
            maxs, mins = sizes.max(), sizes.min()
            bal = (maxs - sizes) / (1.0 + maxs - mins)
            score = np.where(has_room, g + bal, -np.inf)
            p = int(np.argmax(score))
        else:
            p = int(np.argmin(sizes))
        assigned[e] = p
        sizes[p] += 1
        replicas[u, p] = True
        replicas[v, p] = True


def _hep(graph: Graph, k: int, seed: int, tau: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    deg = graph.degrees()
    threshold = tau * max(deg.mean(), 1.0)
    high = deg > threshold
    # Edge is streamed iff it touches a high-degree vertex.
    streamed = high[graph.src] | high[graph.dst]
    in_memory = ~streamed
    capacity = int(np.ceil(1.02 * graph.num_edges / k))

    assigned = _neighborhood_expansion(graph, in_memory, capacity, k)
    _hdrf_stream(graph, assigned, k, capacity, rng, deg)
    return assigned.astype(np.int32)


def hep10(graph: Graph, k: int, seed: int = 0) -> np.ndarray:
    return _hep(graph, k, seed, tau=10.0)


def hep100(graph: Graph, k: int, seed: int = 0) -> np.ndarray:
    return _hep(graph, k, seed, tau=100.0)


def blockrow(graph: Graph, k: int, seed: int = 0) -> np.ndarray:
    """1.5D block-row assignment (CAGNET-style): vertex v's contiguous block
    owns every edge whose DESTINATION is v. Needs no heuristic pass at all —
    the near-zero partitioning-time end of the amortization trade-off — and
    is the layout the reference's `BlockRowBook` / `RingSync` pipeline
    around (not yet in this port). Usable as a
    plain edge partitioner too (halo/dense run on it), which is what makes
    partition layout and sync strategy independent axes."""
    del seed  # deterministic: blocks are contiguous vertex ranges
    v_block = -(-graph.num_vertices // k)  # ceil(V / k)
    return (graph.dst.astype(np.int64) // v_block).astype(np.int32)


EDGE_PARTITIONERS: dict[str, Callable[..., np.ndarray]] = {
    "random": random_edge,
    "dbh": dbh,
    "hdrf": hdrf,
    "2ps-l": two_ps_l,
    "hep10": hep10,
    "hep100": hep100,
    "blockrow": blockrow,
}


def partition_edges(graph: Graph, k: int, method: str, seed: int = 0, **kw) -> np.ndarray:
    if method not in EDGE_PARTITIONERS:
        raise ValueError(f"unknown edge partitioner {method!r}; options: {sorted(EDGE_PARTITIONERS)}")
    out = EDGE_PARTITIONERS[method](graph, k, seed=seed, **kw)
    assert out.shape == (graph.num_edges,)
    return out.astype(np.int32)

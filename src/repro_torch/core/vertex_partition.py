# Copy of repro/core/vertex_partition.py (NumPy only), imports redirected to repro_torch;
# tests/test_torch_host.py holds its results equal to the original.
"""Vertex partitioners (edge-cut) — the six used in the paper's DistDGL study.

  random  — stateless streaming baseline
  ldg     — Linear Deterministic Greedy (Stanton & Kliot, KDD'12)
  spinner — label-propagation partitioning (Martella et al., ICDE'17)
  bytegnn — BFS-block partitioning with training-vertex balance
            (Zheng et al., VLDB'22)
  metis   — multilevel k-way (heavy-edge-matching coarsening, greedy-growing
            initial partition, boundary-FM refinement) — faithful multilevel
            reimplementation of the METIS scheme
  kahip   — same multilevel machinery with stronger local search and V-cycles
            (KaHIP 'strong social' flavour)

All return int32[V] vertex→partition assignments, deterministic given seed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core.graph import Graph

__all__ = ["VERTEX_PARTITIONERS", "partition_vertices"]


# ---------------------------------------------------------------------------
# Streaming
# ---------------------------------------------------------------------------


def random_vertex(graph: Graph, k: int, seed: int = 0, **_) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, k, size=graph.num_vertices, dtype=np.int32)


def ldg(graph: Graph, k: int, seed: int = 0, **_) -> np.ndarray:
    """LDG: stream vertices; send v to argmax_i |N(v) ∩ P_i| (1 - |P_i|/C)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(graph.num_vertices)
    indptr, indices = graph.csr()
    out = np.full(graph.num_vertices, -1, dtype=np.int32)
    sizes = np.zeros(k, dtype=np.int64)
    capacity = max(graph.num_vertices / k, 1.0)
    for v in order:
        v = int(v)
        nbrs = indices[indptr[v] : indptr[v + 1]]
        placed = out[nbrs]
        placed = placed[placed >= 0]
        counts = np.bincount(placed, minlength=k) if placed.size else np.zeros(k)
        score = counts * (1.0 - sizes / capacity)
        # Tie-break to the least-loaded partition (Stanton & Kliot).
        p = int(np.lexsort((sizes, -score))[0])
        out[v] = p
        sizes[p] += 1
    return out


# ---------------------------------------------------------------------------
# Spinner — label propagation with load penalty
# ---------------------------------------------------------------------------


def spinner(
    graph: Graph,
    k: int,
    seed: int = 0,
    iterations: int = 20,
    balance_slack: float = 0.05,
    **_,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, k, size=graph.num_vertices, dtype=np.int64)
    capacity = (1.0 + balance_slack) * graph.num_edges * 2.0 / k  # edge-capacity
    deg = graph.degrees().astype(np.int64)
    src = np.concatenate([graph.src, graph.dst]).astype(np.int64)
    dst = np.concatenate([graph.dst, graph.src]).astype(np.int64)
    for _ in range(iterations):
        # counts[v, l] = #neighbors of v with label l
        counts = np.zeros((graph.num_vertices, k), dtype=np.float32)
        np.add.at(counts, (src, labels[dst]), 1.0)
        load = np.zeros(k, dtype=np.float64)
        np.add.at(load, labels, deg)
        penalty = np.maximum(1.0 - load / capacity, 0.0)  # remaining headroom
        score = counts * penalty[None, :].astype(np.float32)
        new_labels = np.asarray(np.argmax(score, axis=1), dtype=np.int64)
        # Probabilistic adoption (Spinner flips with prob to avoid oscillation)
        flip = rng.random(graph.num_vertices) < 0.5
        changed = (new_labels != labels) & flip
        if not changed.any():
            break
        labels = np.where(changed, new_labels, labels)
    return labels.astype(np.int32)


# ---------------------------------------------------------------------------
# ByteGNN — BFS blocks + greedy multi-objective block assignment
# ---------------------------------------------------------------------------


def bytegnn(
    graph: Graph,
    k: int,
    seed: int = 0,
    train_mask: Optional[np.ndarray] = None,
    block_hops: int = 2,
    **_,
) -> np.ndarray:
    """ByteGNN partitioning: grow small BFS blocks from training vertices
    (matching the sampling locality of mini-batch GNN training), then greedily
    assign blocks to machines balancing training vertices first and total
    vertices second.
    """
    rng = np.random.default_rng(seed)
    n = graph.num_vertices
    if train_mask is None:
        train_mask = np.ones(n, dtype=bool)
    indptr, indices = graph.csr()
    block_of = np.full(n, -1, dtype=np.int64)
    seeds = np.where(train_mask)[0]
    rng.shuffle(seeds)
    # Block size target keeps ~4k blocks so packing has freedom.
    num_blocks = 0
    budget = max(n // max(4 * k, 1), 8)
    for s in seeds:
        if block_of[s] >= 0:
            continue
        bid = num_blocks
        num_blocks += 1
        frontier = [int(s)]
        block_of[s] = bid
        size = 1
        for _ in range(block_hops):
            nxt: list[int] = []
            for u in frontier:
                nbrs = indices[indptr[u] : indptr[u + 1]]
                free = nbrs[block_of[nbrs] < 0]
                take = free[: max(budget - size, 0)]
                block_of[take] = bid
                size += take.shape[0]
                nxt.extend(int(t) for t in take)
                if size >= budget:
                    break
            frontier = nxt
            if size >= budget or not frontier:
                break
    # Orphans (unreached vertices) become singleton blocks.
    orphans = np.where(block_of < 0)[0]
    block_of[orphans] = num_blocks + np.arange(orphans.shape[0])
    num_blocks += orphans.shape[0]

    # Greedy assignment, largest block first; lexicographic objective
    # (train balance, vertex balance).
    train_per_block = np.zeros(num_blocks, dtype=np.int64)
    np.add.at(train_per_block, block_of[train_mask], 1)
    size_per_block = np.bincount(block_of, minlength=num_blocks).astype(np.int64)
    out = np.empty(n, dtype=np.int32)
    part_train = np.zeros(k, dtype=np.int64)
    part_size = np.zeros(k, dtype=np.int64)
    block_part = np.empty(num_blocks, dtype=np.int32)
    for b in np.argsort(-(train_per_block * n + size_per_block)):
        p = int(np.lexsort((part_size, part_train))[0])
        block_part[b] = p
        part_train[p] += train_per_block[b]
        part_size[p] += size_per_block[b]
    out = block_part[block_of]
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Multilevel k-way (METIS / KaHIP style)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Level:
    """A coarsened weighted graph plus the projection map to the finer one."""

    num_vertices: int
    indptr: np.ndarray
    indices: np.ndarray
    eweights: np.ndarray
    vweights: np.ndarray
    fine_to_coarse: Optional[np.ndarray]  # None at the finest level


def _build_weighted_csr(
    n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrised weighted CSR with duplicate edges merged (weights summed)."""
    s = np.concatenate([src, dst]).astype(np.int64)
    d = np.concatenate([dst, src]).astype(np.int64)
    ww = np.concatenate([w, w]).astype(np.int64)
    key = s * n + d
    uniq, inv = np.unique(key, return_inverse=True)
    wsum = np.zeros(uniq.shape[0], dtype=np.int64)
    np.add.at(wsum, inv, ww)
    us = (uniq // n).astype(np.int64)
    ud = (uniq % n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(us, minlength=n), out=indptr[1:])
    return indptr, ud.astype(np.int32), wsum


def _heavy_edge_matching(level: _Level, rng: np.random.Generator) -> np.ndarray:
    """Heavy-edge matching: visit vertices in random order, match each with
    its unmatched neighbor of maximum edge weight. Returns match[] with the
    partner (or self)."""
    n = level.num_vertices
    match = np.full(n, -1, dtype=np.int64)
    order = rng.permutation(n)
    indptr, indices, ew = level.indptr, level.indices, level.eweights
    for v in order:
        v = int(v)
        if match[v] >= 0:
            continue
        lo, hi = indptr[v], indptr[v + 1]
        nbrs = indices[lo:hi]
        free = match[nbrs] < 0
        cand = nbrs[free]
        if cand.shape[0] == 0:
            match[v] = v
            continue
        wts = ew[lo:hi][free]
        u = int(cand[np.argmax(wts)])
        if u == v:
            match[v] = v
        else:
            match[v] = u
            match[u] = v
    return match


def _coarsen(level: _Level, rng: np.random.Generator) -> _Level:
    match = _heavy_edge_matching(level, rng)
    n = level.num_vertices
    rep = np.minimum(np.arange(n), match)  # representative of each pair
    _, coarse_id = np.unique(rep, return_inverse=True)
    nc = int(coarse_id.max()) + 1
    vw = np.zeros(nc, dtype=np.int64)
    np.add.at(vw, coarse_id, level.vweights)
    # Contract edges, dropping the ones internal to a matched pair.
    cs = coarse_id[_csr_expand_src(level)]
    cd = coarse_id[level.indices]
    keep = cs < cd  # upper triangle (csr already symmetric), drops self-loops
    indptr, indices, ew = _build_weighted_csr(nc, cs[keep], cd[keep], level.eweights[keep])
    return _Level(nc, indptr, indices, ew, vw, fine_to_coarse=coarse_id)


def _csr_expand_src(level: _Level) -> np.ndarray:
    cached = getattr(level, "_src_cache", None)
    if cached is None:
        cached = np.repeat(
            np.arange(level.num_vertices, dtype=np.int64), np.diff(level.indptr)
        )
        level._src_cache = cached  # type: ignore[attr-defined]
    return cached


def _lp_initial_partition(
    level: _Level, k: int, rng: np.random.Generator, iterations: int = 12
) -> np.ndarray:
    """Label-propagation initial partition + balance repair.

    LP finds the community structure (what makes dense social graphs
    partitionable at all); the repair step then moves lowest-connectivity
    vertices out of overloaded labels until balance holds. Mirrors the
    LP-based initialisation of modern multilevel partitioners.
    """
    n = level.num_vertices
    indptr, indices, ew = level.indptr, level.indices, level.eweights
    esrc = _csr_expand_src(level)
    vw = level.vweights.astype(np.float64)
    labels = rng.integers(0, k, size=n, dtype=np.int64)
    total = vw.sum()
    cap = 1.02 * total / k
    for _ in range(iterations):
        conn = np.zeros((n, k), dtype=np.int64)
        np.add.at(conn, (esrc, labels[indices]), ew)
        load = np.zeros(k)
        np.add.at(load, labels, vw)
        headroom = np.maximum(1.0 - load / cap, 0.05)
        new = np.argmax(conn * headroom[None, :], axis=1)
        flip = rng.random(n) < 0.7
        labels = np.where(flip, new, labels)
    # balance repair: evict lowest-attachment vertices from overloaded labels
    conn = np.zeros((n, k), dtype=np.int64)
    np.add.at(conn, (esrc, labels[indices]), ew)
    load = np.zeros(k)
    np.add.at(load, labels, vw)
    max_load = 1.05 * total / k
    for p in range(k):
        if load[p] <= max_load:
            continue
        members = np.where(labels == p)[0]
        # weakest attachment to p first
        order = members[np.argsort(conn[members, p])]
        for v in order:
            if load[p] <= max_load:
                break
            alt = conn[v].copy()
            alt[p] = -1
            loads_ok = load + vw[v] <= max_load
            loads_ok[p] = False
            if not loads_ok.any():
                t = int(np.argmin(load + (~loads_ok) * 1e18))
            else:
                alt[~loads_ok] = -1
                t = int(np.argmax(alt))
            load[p] -= vw[v]
            load[t] += vw[v]
            labels[v] = t
    return labels.astype(np.int32)


def _initial_partition(level: _Level, k: int, rng: np.random.Generator) -> np.ndarray:
    """Greedy graph growing: BFS-grow each partition to ~total_weight/k."""
    n = level.num_vertices
    target = level.vweights.sum() / k
    out = np.full(n, -1, dtype=np.int32)
    indptr, indices = level.indptr, level.indices
    order = iter(rng.permutation(n))
    for p in range(k - 1):
        w = 0.0
        frontier: list[int] = []
        while w < target:
            if not frontier:
                s = next((int(x) for x in order if out[int(x)] < 0), None)
                if s is None:
                    break
                frontier = [s]
                out[s] = p
                w += level.vweights[s]
            u = frontier.pop()
            for x in indices[indptr[u] : indptr[u + 1]]:
                x = int(x)
                if out[x] < 0 and w < target:
                    out[x] = p
                    w += level.vweights[x]
                    frontier.append(x)
    out[out < 0] = k - 1
    return out


def _fm_refine(
    level: _Level,
    part: np.ndarray,
    k: int,
    rng: np.random.Generator,
    passes: int,
    allow_zero_gain: bool,
    slack: float = 0.05,
) -> np.ndarray:
    """Greedy boundary refinement (FM-flavoured, vectorised per pass).

    Per pass: compute, for every vertex, its connectivity to each partition;
    move boundary vertices with positive (or zero, for the KaHIP flavour)
    gain to their best partition when balance allows, in random order with
    sequentially-updated load accounting.
    """
    n = level.num_vertices
    indptr, indices, ew = level.indptr, level.indices, level.eweights
    esrc = _csr_expand_src(level)
    vw = level.vweights
    max_load = (1.0 + slack) * vw.sum() / k
    part = part.astype(np.int64).copy()
    for _ in range(passes):
        conn = np.zeros((n, k), dtype=np.int64)
        np.add.at(conn, (esrc, part[indices]), ew)
        internal = conn[np.arange(n), part]
        best_other = conn.copy()
        best_other[np.arange(n), part] = -1
        target = np.argmax(best_other, axis=1)
        gain = best_other[np.arange(n), target] - internal
        thresh = -1 if allow_zero_gain else 0
        movable = np.where(gain > thresh)[0]
        if movable.shape[0] == 0:
            break
        load = np.zeros(k, dtype=np.float64)
        np.add.at(load, part, vw)
        moved = 0
        for v in rng.permutation(movable):
            v = int(v)
            t = int(target[v])
            if gain[v] <= thresh or t == part[v]:
                continue
            if load[t] + vw[v] > max_load:
                continue
            load[part[v]] -= vw[v]
            load[t] += vw[v]
            part[v] = t
            moved += 1
        if moved == 0:
            break
    return part.astype(np.int32)


def _finest_level(graph: Graph) -> _Level:
    w = np.ones(graph.num_edges, dtype=np.int64)
    indptr, indices, ew = _build_weighted_csr(
        graph.num_vertices, graph.src.astype(np.int64), graph.dst.astype(np.int64), w
    )
    return _Level(
        graph.num_vertices, indptr, indices, ew,
        np.ones(graph.num_vertices, dtype=np.int64), None,
    )


def _multilevel(
    graph: Graph,
    k: int,
    seed: int,
    refine_passes: int,
    vcycles: int,
    allow_zero_gain: bool,
    coarsen_to: int = 256,
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    finest = _finest_level(graph)
    levels = [finest]
    while levels[-1].num_vertices > max(coarsen_to, 4 * k):
        nxt = _coarsen(levels[-1], rng)
        if nxt.num_vertices >= 0.95 * levels[-1].num_vertices:
            break  # matching stalled (e.g. star graphs)
        levels.append(nxt)

    # Several initial partitions on the coarsest level; keep the best cut
    # after refinement (METIS does multiple initial bisection attempts).
    coarsest = levels[-1]
    esrc_c = _csr_expand_src(coarsest)
    best_part, best_cut = None, np.inf
    for attempt in range(4):
        if attempt % 2 == 0:
            cand = _lp_initial_partition(coarsest, k, rng)
        else:
            cand = _initial_partition(coarsest, k, rng)
        cand = _fm_refine(coarsest, cand, k, rng, refine_passes, allow_zero_gain)
        cut = float(
            (coarsest.eweights * (cand[esrc_c] != cand[coarsest.indices])).sum()
        )
        if cut < best_cut:
            best_part, best_cut = cand, cut
    part = best_part
    for fine, coarse in zip(reversed(levels[:-1]), reversed(levels[1:])):
        part = part[coarse.fine_to_coarse]
        part = _fm_refine(fine, part, k, rng, refine_passes, allow_zero_gain)

    for _ in range(vcycles):  # KaHIP-style V-cycles on the finest level
        part = _fm_refine(finest, part, k, rng, refine_passes, allow_zero_gain=True)
        # Positive-gain cleanup counters zero-gain drift.
        part = _fm_refine(finest, part, k, rng, 2, allow_zero_gain=False)
    return part


def metis_like(graph: Graph, k: int, seed: int = 0, **_) -> np.ndarray:
    return _multilevel(graph, k, seed, refine_passes=4, vcycles=0, allow_zero_gain=False)


def kahip_like(graph: Graph, k: int, seed: int = 0, repeats: int = 3, **_) -> np.ndarray:
    """KaHIP 'strong' flavour: repeated multilevel runs with deeper
    refinement and V-cycles; keep the best cut. Slowest partitioner,
    best cut — exactly its profile in the paper (Fig. 13/15)."""
    best: Optional[np.ndarray] = None
    best_cut = np.inf
    finest = _finest_level(graph)
    for r in range(repeats):
        part = _multilevel(
            graph, k, seed + 1000 * r, refine_passes=8, vcycles=1, allow_zero_gain=True
        )
        # One final positive-gain-only cleanup pass counters zero-gain drift.
        rng = np.random.default_rng(seed + 1000 * r + 17)
        part = _fm_refine(finest, part, k, rng, 2, allow_zero_gain=False)
        cut = float((part[graph.src] != part[graph.dst]).sum())
        if cut < best_cut:
            best_cut = cut
            best = part
    assert best is not None
    return best


VERTEX_PARTITIONERS: dict[str, Callable[..., np.ndarray]] = {
    "random": random_vertex,
    "ldg": ldg,
    "spinner": spinner,
    "bytegnn": bytegnn,
    "metis": metis_like,
    "kahip": kahip_like,
}


def partition_vertices(
    graph: Graph,
    k: int,
    method: str,
    seed: int = 0,
    train_mask: Optional[np.ndarray] = None,
    **kw,
) -> np.ndarray:
    if method not in VERTEX_PARTITIONERS:
        raise ValueError(
            f"unknown vertex partitioner {method!r}; options: {sorted(VERTEX_PARTITIONERS)}"
        )
    if method == "bytegnn":
        kw["train_mask"] = train_mask
    out = VERTEX_PARTITIONERS[method](graph, k, seed=seed, **kw)
    assert out.shape == (graph.num_vertices,)
    return out.astype(np.int32)

# Copy of repro/core/graph.py (NumPy only), imports redirected to repro_torch;
# tests/test_torch_host.py holds its results equal to the original.
"""Graph container + synthetic generators for the five paper graph categories.

The paper (Table 1) uses five graphs: Hollywood-2011 (collaboration),
Dimacs9-USA (road), Enwiki-2021 (wiki), Eu-2015-tpd (web), Orkut (social).
They range 58M-234M edges — far beyond a CPU container — so we provide
generators that reproduce each category's *structural signature* (degree-law
exponent, clustering style, directedness) at a configurable scale. All
generators are deterministic given a seed.

Everything here is NumPy on purpose: graph loading/partitioning is host-side
preprocessing in every real system (DistDGL, DistGNN, METIS); the device
compute starts after partitioning.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = [
    "Graph",
    "generate_graph",
    "GRAPH_CATEGORIES",
    "paper_graph",
    "PAPER_GRAPHS",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable graph in COO + CSR form.

    Edges are stored once (canonical direction). ``directed=False`` means each
    stored edge represents both directions; the CSR adjacency then contains
    both. Vertex ids are dense ``[0, num_vertices)``.
    """

    num_vertices: int
    src: np.ndarray  # int32 [E]
    dst: np.ndarray  # int32 [E]
    directed: bool
    name: str = "graph"
    # CSR over the *message* direction (in-neighbors of each vertex),
    # built lazily via `csr()`; cached in __dict__ despite frozen dataclass.

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    # -- degree utilities ---------------------------------------------------
    def out_degrees(self) -> np.ndarray:
        deg = np.bincount(self.src, minlength=self.num_vertices)
        if not self.directed:
            deg = deg + np.bincount(self.dst, minlength=self.num_vertices)
        return deg.astype(np.int64)

    def in_degrees(self) -> np.ndarray:
        deg = np.bincount(self.dst, minlength=self.num_vertices)
        if not self.directed:
            deg = deg + np.bincount(self.src, minlength=self.num_vertices)
        return deg.astype(np.int64)

    def degrees(self) -> np.ndarray:
        """Total degree (used by degree-based partitioners like DBH)."""
        d = np.bincount(self.src, minlength=self.num_vertices) + np.bincount(
            self.dst, minlength=self.num_vertices
        )
        return d.astype(np.int64)

    # -- CSR (both directions; neighbors for sampling/aggregation) ----------
    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        """Returns (indptr, indices) of the symmetrised adjacency.

        GNN aggregation and neighbor sampling in DGL operate on the
        message graph; like the paper's systems we symmetrise directed
        graphs for neighborhood computation.
        """
        cached = self.__dict__.get("_csr")
        if cached is not None:
            return cached
        s = np.concatenate([self.src, self.dst])
        d = np.concatenate([self.dst, self.src])
        order = np.argsort(s, kind="stable")
        s_sorted = s[order]
        d_sorted = d[order]
        indptr = np.zeros(self.num_vertices + 1, dtype=np.int64)
        counts = np.bincount(s_sorted, minlength=self.num_vertices)
        np.cumsum(counts, out=indptr[1:])
        object.__setattr__(self, "_csr", (indptr, d_sorted.astype(np.int32)))
        return self.__dict__["_csr"]

    def neighbors(self, v: int) -> np.ndarray:
        indptr, indices = self.csr()
        return indices[indptr[v] : indptr[v + 1]]

    def validate(self) -> None:
        assert self.src.dtype == np.int32 and self.dst.dtype == np.int32
        assert self.src.shape == self.dst.shape
        assert self.src.min(initial=0) >= 0 and self.dst.min(initial=0) >= 0
        if self.num_edges:
            assert int(self.src.max()) < self.num_vertices
            assert int(self.dst.max()) < self.num_vertices


def _dedupe(src: np.ndarray, dst: np.ndarray, directed: bool) -> tuple[np.ndarray, np.ndarray]:
    """Remove self-loops and duplicate edges (canonicalised if undirected)."""
    mask = src != dst
    src, dst = src[mask], dst[mask]
    if not directed:
        lo = np.minimum(src, dst)
        hi = np.maximum(src, dst)
        src, dst = lo, hi
    key = src.astype(np.int64) * (int(max(src.max(initial=0), dst.max(initial=0))) + 1) + dst
    _, idx = np.unique(key, return_index=True)
    idx.sort()
    return src[idx], dst[idx]


# ---------------------------------------------------------------------------
# Generators, one per paper category.
# ---------------------------------------------------------------------------


def _rmat(
    num_vertices: int,
    num_edges: int,
    rng: np.random.Generator,
    a: float,
    b: float,
    c: float,
) -> tuple[np.ndarray, np.ndarray]:
    """R-MAT/Kronecker generator — standard power-law graph model.

    Vectorised: every bit of every edge endpoint is drawn at once.
    """
    scale = int(np.ceil(np.log2(max(num_vertices, 2))))
    n = 1 << scale
    # Oversample to survive dedupe.
    m = int(num_edges * 1.35) + 16
    d = 1.0 - a - b - c
    probs = np.array([a, b, c, d])
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        quad = rng.choice(4, size=m, p=probs)
        src = (src << 1) | (quad >> 1)
        dst = (dst << 1) | (quad & 1)
    # Permute ids so the power-law isn't aligned with id order (realistic).
    perm = rng.permutation(n)
    src = perm[src] % num_vertices
    dst = perm[dst] % num_vertices
    return src.astype(np.int32), dst.astype(np.int32)


def _with_communities(
    n: int,
    m: int,
    rng: np.random.Generator,
    rmat_params: tuple[float, float, float],
    intra_frac: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Power-law graph with planted community structure.

    Real social/web/wiki graphs combine a heavy-tailed degree law with strong
    locality (communities / host-local links) — that locality is exactly what
    in-memory partitioners (METIS/KaHIP/HEP) exploit and what pure R-MAT
    lacks. We draw `intra_frac` of the edges inside power-law-sized
    communities and the rest from a global R-MAT.
    """
    m_intra = int(m * intra_frac)
    m_global = m - m_intra
    a, b, c = rmat_params
    gs, gd = _rmat(n, m_global, rng, a=a, b=b, c=c)

    # Power-law community sizes laid out contiguously in a *hidden* order.
    sizes = np.clip((rng.pareto(1.3, size=max(n // 40, 8)) + 1.0) * 30, 8, n // 4)
    sizes = sizes.astype(np.int64)
    bounds = np.cumsum(sizes)
    bounds = bounds[bounds < n]
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [n]])
    widths = ends - starts
    # Sample intra edges proportional to community size (degree-balanced-ish).
    comm = rng.choice(starts.shape[0], size=m_intra, p=widths / widths.sum())
    lo = starts[comm]
    w = widths[comm]
    # Within a community, prefer low offsets (local hubs): squared trick.
    u = lo + (rng.random(m_intra) ** 2 * w).astype(np.int64)
    v = lo + (rng.random(m_intra) * w).astype(np.int64)
    # Hide the contiguous layout behind a random permutation.
    perm = rng.permutation(n)
    src = np.concatenate([perm[u], gs.astype(np.int64)]).astype(np.int32)
    dst = np.concatenate([perm[v], gd.astype(np.int64)]).astype(np.int32)
    return src, dst


def _social(n: int, m: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray, bool]:
    """Orkut-like: undirected, heavy-tailed, strong community structure."""
    src, dst = _with_communities(n, m, rng, (0.57, 0.19, 0.19), intra_frac=0.75)
    return src, dst, False


def _web(n: int, m: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray, bool]:
    """Eu-2015-like: directed, very skewed, host-local link blocks."""
    src, dst = _with_communities(n, m, rng, (0.65, 0.15, 0.15), intra_frac=0.85)
    return src, dst, True


def _wiki(n: int, m: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray, bool]:
    """Enwiki-like: directed, skewed in-degree, topic-cluster locality."""
    src, dst = _with_communities(n, m, rng, (0.6, 0.2, 0.1), intra_frac=0.65)
    return src, dst, True


def _collab(n: int, m: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray, bool]:
    """Hollywood-like: undirected, dense clique-ish collaboration cliques.

    Model: sample "movies" (cliques) with power-law cast sizes and connect
    cast pairwise, which matches how Hollywood-2011 is built.
    """
    src_list = []
    dst_list = []
    total = 0
    while total < m:
        size = min(2 + int(rng.pareto(1.6) * 3), 60)
        cast = rng.integers(0, n, size=size)
        iu, ju = np.triu_indices(size, k=1)
        src_list.append(cast[iu])
        dst_list.append(cast[ju])
        total += iu.shape[0]
    return (
        np.concatenate(src_list).astype(np.int32),
        np.concatenate(dst_list).astype(np.int32),
        False,
    )


def _road(n: int, m: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray, bool]:
    """Dimacs9-USA-like: directed, near-planar grid with low max degree,
    huge diameter, |E| ≈ 2.4 |V|."""
    side = int(np.ceil(np.sqrt(n)))
    n = side * side
    v = np.arange(n, dtype=np.int64)
    right = v + 1
    down = v + side
    ok_r = (v % side) != side - 1
    ok_d = down < n
    src = np.concatenate([v[ok_r], v[ok_d]])
    dst = np.concatenate([right[ok_r], down[ok_d]])
    # Random long-ish "highway" shortcuts, few of them.
    extra = max(int(0.03 * src.shape[0]), 1)
    es = rng.integers(0, n, size=extra)
    ed = np.clip(es + rng.integers(-3 * side, 3 * side, size=extra), 0, n - 1)
    src = np.concatenate([src, es])
    dst = np.concatenate([dst, ed])
    # Both directions exist in DIMACS (directed representation).
    return src.astype(np.int32), dst.astype(np.int32), True


GRAPH_CATEGORIES = {
    "social": _social,
    "web": _web,
    "wiki": _wiki,
    "collab": _collab,
    "road": _road,
}

# Scaled-down stand-ins for the paper's Table 1 (same |E|/|V| ratio shape).
# name: (category, |V| at scale=1.0, |E| target at scale=1.0)
PAPER_GRAPHS: dict[str, tuple[str, int, int]] = {
    "HO": ("collab", 8_000, 900_000),   # Hollywood-2011: 2M V / 229M E (dense)
    "DI": ("road", 120_000, 290_000),   # Dimacs9-USA: 24M V / 58M E (sparse)
    "EN": ("wiki", 40_000, 1_000_000),  # Enwiki-2021: 6M V / 150M E
    "EU": ("web", 45_000, 1_050_000),   # Eu-2015-tpd: 7M V / 166M E
    "OR": ("social", 25_000, 1_900_000),  # Orkut: 3M V / 234M E (dense)
}


def generate_graph(
    category: str,
    num_vertices: int,
    num_edges: int,
    *,
    seed: int = 0,
    name: Optional[str] = None,
) -> Graph:
    if category not in GRAPH_CATEGORIES:
        raise ValueError(f"unknown category {category!r}; options: {sorted(GRAPH_CATEGORIES)}")
    rng = np.random.default_rng(seed)
    src, dst, directed = GRAPH_CATEGORIES[category](num_vertices, num_edges, rng)
    src, dst = _dedupe(src, dst, directed)
    # Trim to the requested edge budget deterministically.
    if src.shape[0] > num_edges:
        keep = rng.permutation(src.shape[0])[:num_edges]
        keep.sort()
        src, dst = src[keep], dst[keep]
    # Honor the requested vertex count for every category: keep isolated
    # vertices (ids past the max referenced id) instead of silently shrinking
    # |V|, which would skew vertex-balance metrics. Road grids may exceed the
    # request because the generator rounds |V| up to a full square.
    n = int(max(src.max(initial=0), dst.max(initial=0))) + 1 if src.size else num_vertices
    g = Graph(
        num_vertices=max(n, num_vertices),
        src=src.astype(np.int32),
        dst=dst.astype(np.int32),
        directed=directed,
        name=name or f"{category}-{num_vertices}v",
    )
    g.validate()
    return g


def paper_graph(key: str, *, scale: float = 0.1, seed: int = 0) -> Graph:
    """One of the five paper graphs (HO/DI/EN/EU/OR) at a size scale.

    ``scale=1.0`` is already the CPU-tractable stand-in (~1M edges); the
    paper-size originals are 50-250x larger and meant for real clusters.
    """
    cat, nv, ne = PAPER_GRAPHS[key]
    return generate_graph(
        cat,
        max(int(nv * scale), 64),
        max(int(ne * scale), 128),
        seed=seed,
        name=key,
    )

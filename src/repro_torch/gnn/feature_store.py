# Copy of repro/gnn/feature_store.py (NumPy only, with the port's wire
# codecs, fault-injection seam and tracer: `gather` records the
# `store.gather` span and the fetch counters under an installed tracer).
# tests/test_torch_host.py and tests/test_torch_wire.py hold its results
# equal to the original.
"""Partitioned row stores: owner shards + per-worker static caches.

`RowStore` is a partitioned store of [V, d] rows keyed by vertex id — feature
rows during training and per-layer embedding rows during layer-wise
inference serving (gnn/inference.py). Each worker w of a
`VertexPartitionBook` owns its partition's rows; on top it holds a bounded
static cache of remote vertices selected by one of four policies:

  none    — no cache (DistDGL default; every remote vertex crosses the net)
  random  — uniform random remote vertices (ablation baseline)
  degree  — highest-degree remote vertices (PaGraph/BGL-style)
  halo    — 1-hop boundary neighbors, ranked by how many cut edges bind
            them to w

`gather()` splits a batch's input vertices into {local, cache-hit,
remote-miss} and returns the assembled row block plus a `FetchStats` record
(counts and bytes per class). Only *miss* bytes cross the network —
`core/cost_model.py` prices the training fetch phase (`minibatch_step`) and
the serving fetch phase (`serve_request`) from them. A store built with a
lossy wire codec (core/wire.py) serves miss rows from their encoded remote
representation: `gather` roundtrips the miss block through encode/decode
on the host (local and cache rows never cross the network and stay
exact), and `FetchStats.wire_bytes` is the measured payload + meta bytes
beside the logical `miss_bytes` (equal under fp32). `FeatureStore` is the
feature-flavored front the mini-batch trainer loads its input rows through.
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.partition_book import VertexPartitionBook
from repro_torch.core.wire import Codec, as_codec
from repro_torch.fault import inject as fault_inject
from repro_torch.obs.trace import get_tracer

__all__ = [
    "CACHE_POLICIES",
    "FeatureStore",
    "FetchStats",
    "RowStore",
    "select_cache_vertices",
]

CACHE_POLICIES = ("none", "random", "degree", "halo")


class FetchStats(NamedTuple):
    """Per-lookup feature-loading accounting (one worker, one batch).

    `miss_bytes` is the logical (f32) volume of rows that crossed the
    network; `wire_bytes` is what the store's codec shipped for them
    (== miss_bytes under fp32).
    """

    num_input: int
    num_local: int
    num_cache_hit: int
    num_remote_miss: int
    local_bytes: int
    hit_bytes: int
    miss_bytes: int
    wire_bytes: int = 0

    @property
    def num_remote(self) -> int:
        return self.num_cache_hit + self.num_remote_miss

    @property
    def hit_rate(self) -> float:
        """Cache hits / remote requests (1.0 when nothing is remote)."""
        return self.num_cache_hit / self.num_remote if self.num_remote else 1.0

    @classmethod
    def merge(cls, stats: "list[FetchStats]") -> "FetchStats":
        """Field-wise sum; an empty list is the zero record (the serving
        engine legitimately sees zero-request micro-batch windows)."""
        return cls(*(int(sum(s[i] for s in stats))
                     for i in range(len(cls._fields))))


def select_cache_vertices(
    graph: Graph,
    book: VertexPartitionBook,
    policy: str,
    budget: int,
    seed: int = 0,
) -> list[np.ndarray]:
    """Static cache contents: per worker, the global ids of cached remote
    vertices (deterministic given seed; each array has <= budget entries)."""
    if policy not in CACHE_POLICIES:
        raise ValueError(f"unknown cache policy {policy!r}; options: {CACHE_POLICIES}")
    k, V = book.k, book.num_vertices
    owner = book.owner
    if policy == "none" or budget <= 0:
        return [np.zeros(0, np.int64) for _ in range(k)]

    if policy == "degree":
        # Hub-first: one global degree order, filtered per worker.
        order = np.argsort(-graph.degrees(), kind="stable")
        return [order[owner[order] != w][:budget].astype(np.int64) for w in range(k)]

    if policy == "halo":
        # Boundary-first: remote endpoints of cut edges, ranked by the number
        # of cut edges binding them to this partition (ties: degree, then id).
        src = graph.src.astype(np.int64)
        dst = graph.dst.astype(np.int64)
        cut = owner[src] != owner[dst]
        cs, cd = src[cut], dst[cut]
        pw = np.concatenate([owner[cs], owner[cd]]).astype(np.int64)
        pv = np.concatenate([cd, cs])
        uniq, counts = np.unique(pw * V + pv, return_counts=True)
        w_of = (uniq // V).astype(np.int64)
        v_of = (uniq % V).astype(np.int64)
        deg = graph.degrees()
        out = []
        for w in range(k):
            sel = w_of == w
            v, c = v_of[sel], counts[sel]
            order = np.lexsort((v, -deg[v], -c))
            out.append(v[order][:budget])
        return out

    # random baseline
    out = []
    for w in range(k):
        remote = np.where(owner != w)[0]
        rng = np.random.default_rng(seed + 7919 * w)
        n = min(budget, remote.shape[0])
        pick = rng.choice(remote, size=n, replace=False) if n else remote[:0]
        out.append(np.sort(pick).astype(np.int64))
    return out


@dataclasses.dataclass(frozen=True)
class RowStore:
    """Generic partitioned row store: owner shards + per-worker static caches.

    `rows` (the global [V, d] array) doubles as the union of owner shards
    and as the remote KV store for misses; cache hits are served from
    `cache_rows`, the copies frozen at build time. A built store is
    immutable: `split`/`stats`/`gather` only read its fields.
    """

    book: VertexPartitionBook
    policy: str
    budget: int
    row_dim: int
    bytes_per_row: int
    # Per-worker caches as SORTED id arrays (membership via searchsorted);
    # cache_rows is aligned with cache_ids.
    cache_ids: np.ndarray           # int64 [k, max_cache]; pad -> num_vertices
    cache_sizes: np.ndarray         # int64 [k]: true cache entries per worker
    cache_rows: Optional[np.ndarray]  # [k, max_cache, d] cached copies
    rows: Optional[np.ndarray]        # global [V, d] (None = accounting-only)
    # wire codec for remote-miss rows (None -> fp32 == exact)
    codec: Optional[Codec] = None

    @classmethod
    def create(
        cls,
        book: VertexPartitionBook,
        cache_vertices: "list[np.ndarray]",
        *,
        rows: Optional[np.ndarray] = None,
        row_dim: Optional[int] = None,
        policy: str = "none",
        budget: int = 0,
        codec=None,
    ) -> "RowStore":
        """Build a store whose worker-w cache holds `cache_vertices[w]`.

        With `rows=None` the store is accounting-only (split/stats work,
        gather does not) — `row_dim` then sizes the byte metrics.
        """
        if rows is not None:
            row_dim = int(rows.shape[1])
        if row_dim is None:
            raise ValueError("need rows or row_dim for byte accounting")
        ids = [np.sort(np.asarray(c, dtype=np.int64)) for c in cache_vertices]
        sizes = np.array([c.shape[0] for c in ids], dtype=np.int64)
        max_cache = int(sizes.max()) if sizes.size else 0
        # pad with num_vertices: sorts after every real id, never matches one
        cache_ids = np.full((book.k, max_cache), book.num_vertices, dtype=np.int64)
        crows = None
        if rows is not None:
            crows = np.zeros((book.k, max_cache, row_dim), dtype=rows.dtype)
        for w, cw in enumerate(ids):
            cache_ids[w, : cw.shape[0]] = cw
            if crows is not None:
                crows[w, : cw.shape[0]] = rows[cw]
        return cls(
            book=book, policy=policy, budget=int(budget),
            row_dim=row_dim, bytes_per_row=4 * row_dim,
            cache_ids=cache_ids, cache_sizes=sizes, cache_rows=crows,
            rows=rows, codec=as_codec(codec),
        )

    @classmethod
    def from_policy(
        cls,
        graph: Graph,
        book: VertexPartitionBook,
        *,
        policy: str = "none",
        budget: int = 0,
        rows: Optional[np.ndarray] = None,
        row_dim: Optional[int] = None,
        seed: int = 0,
        codec=None,
    ) -> "RowStore":
        """Select the per-worker caches with `select_cache_vertices`, then
        `create` (which subclasses do NOT override, unlike `build`)."""
        ids = select_cache_vertices(graph, book, policy, budget, seed=seed)
        return cls.create(book, ids, rows=rows, row_dim=row_dim,
                          policy=policy, budget=budget, codec=codec)

    def cached_ids(self, worker: int) -> np.ndarray:
        """Global ids cached at `worker` (sorted, cache-row order)."""
        return self.cache_ids[worker, : self.cache_sizes[worker]]

    def split(self, worker: int, ids: np.ndarray):
        """Vectorised {local, cache-hit, remote-miss} split of input ids."""
        ids = np.asarray(ids, dtype=np.int64)
        local = self.book.owner[ids] == worker
        cached = self.cached_ids(worker)
        if cached.shape[0] == 0:
            hit = np.zeros_like(local)
        else:
            pos = np.minimum(np.searchsorted(cached, ids), cached.shape[0] - 1)
            hit = ~local & (cached[pos] == ids)
        miss = ~local & ~hit
        return local, hit, miss

    def _stats_of(self, ids: np.ndarray, local, hit, miss) -> FetchStats:
        nl, nh, nm = int(local.sum()), int(hit.sum()), int(miss.sum())
        b = self.bytes_per_row
        return FetchStats(
            num_input=int(ids.shape[0]),
            num_local=nl, num_cache_hit=nh, num_remote_miss=nm,
            local_bytes=nl * b, hit_bytes=nh * b, miss_bytes=nm * b,
            wire_bytes=as_codec(self.codec).wire_bytes((nm, self.row_dim)),
        )

    def stats(self, worker: int, ids: np.ndarray) -> FetchStats:
        ids = np.asarray(ids, dtype=np.int64)
        return self._stats_of(ids, *self.split(worker, ids))

    def gather(self, worker: int, ids: np.ndarray) -> tuple[np.ndarray, FetchStats]:
        """Assemble the row block for `ids` from shard/cache/remote and
        return it with the phase accounting. Under an installed tracer it
        records the `store.gather` span and the measured `fetch.wire_bytes`
        and `fetch.miss_bytes` counters and the `cache.hit_rate` gauge
        (obs/reconcile.py holds them to the codec's formula)."""
        if self.rows is None:
            raise ValueError("accounting-only store (built without rows)")
        hook = fault_inject.fetch_hook()
        if hook is not None:  # injection seam: may raise TransientFetchFault
            hook(worker, ids)
        tracer = get_tracer()
        t0 = time.perf_counter() if tracer.enabled else 0.0
        ids = np.asarray(ids, dtype=np.int64)
        local, hit, miss = self.split(worker, ids)
        out = np.empty((ids.shape[0], self.row_dim), dtype=self.rows.dtype)
        out[local] = self.rows[ids[local]]                          # owner shard
        slot = np.searchsorted(self.cached_ids(worker), ids[hit])
        out[hit] = self.cache_rows[worker, slot]
        codec = as_codec(self.codec)
        miss_rows = self.rows[ids[miss]]                            # remote fetch
        wire = miss_rows.nbytes  # fp32 ships the rows as they are
        if not codec.lossless and miss_rows.shape[0]:
            # the remote side ships the encoded rows; only their decoded
            # view exists at this worker
            payload, meta = codec.encode(miss_rows)
            wire = payload.nbytes + (0 if meta is None
                                     else np.asarray(meta).nbytes)
            miss_rows = np.asarray(codec.decode(payload, meta),
                                   dtype=self.rows.dtype)
        out[miss] = miss_rows
        stats = self._stats_of(ids, local, hit, miss)
        if tracer.enabled:
            tracer.record_span("store.gather", t0, time.perf_counter(),
                               cat="fetch",
                               args={"worker": int(worker),
                                     "ids": int(ids.shape[0]),
                                     "miss": stats.num_remote_miss})
            tracer.add("fetch.wire_bytes", wire)
            tracer.add("fetch.miss_bytes", stats.miss_bytes)
            tracer.gauge("cache.hit_rate", stats.hit_rate)
        return out, stats._replace(wire_bytes=wire)


class FeatureStore(RowStore):
    """Feature-flavored `RowStore` (the DistDGL feature-loading phase): the
    same store and accounting, with graph-first `build` and
    `features` / `feature_dim`."""

    @classmethod
    def build(
        cls,
        graph: Graph,
        book: VertexPartitionBook,
        *,
        policy: str = "none",
        budget: int = 0,
        features: Optional[np.ndarray] = None,
        feature_dim: Optional[int] = None,
        seed: int = 0,
        codec=None,
    ) -> "FeatureStore":
        """Build the store. With `features=None` the store is accounting-only
        (split/stats work, gather does not) — `feature_dim` then sizes the
        byte metrics."""
        return cls.from_policy(
            graph, book, policy=policy, budget=budget,
            rows=features, row_dim=feature_dim, seed=seed, codec=codec,
        )

    @property
    def features(self) -> Optional[np.ndarray]:
        return self.rows

    @property
    def feature_dim(self) -> int:
        return self.row_dim

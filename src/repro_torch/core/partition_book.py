# Copy of repro/core/partition_book.py (NumPy only), imports redirected to repro_torch;
# tests/test_torch_host.py holds its results equal to the original.
"""Partition books: static device-side layouts + halo routing tables.

This is the bridge between host-side partitioning (NumPy, data-dependent) and
device-side SPMD training (JAX, static shapes). Everything data-dependent is
resolved here, *before* tracing, so the compiled program contains only static
gathers/scatters and fixed-size collectives.

EdgePartitionBook (vertex-cut / DistGNN regime)
  * every edge lives on exactly one partition; cut vertices are replicated
  * each vertex has a unique *master* partition (the replica with the most
    incident edges) — mirrors hold copies
  * replica synchronisation = two static-routed all_to_all rounds:
      reduce:    mirror partials -> master (scatter-add)
      broadcast: master totals  -> mirrors (scatter-set)
    bucket size B = max over ordered partition pairs of the replica list —
    collective bytes therefore scale with the replication factor, which is
    the paper's central mechanism.

VertexPartitionBook (edge-cut / DistDGL regime)
  * every vertex (and its features) lives on exactly one partition
  * mini-batch sampling computes, per step, which remote vertices each
    worker must fetch — the paper's "remote vertices" metric.

BlockRowBook (1.5D block partitioning / CAGNET regime)
  * process row p owns the contiguous vertex block [p*Vb, (p+1)*Vb) — no
    partitioning heuristic, no replicas, every vertex has exactly one home
  * the symmetrised directed edge list is tiled into k x k block-column
    chunks: chunk (p, s) holds the directed edges with dst in block p and
    src in block (p+s) mod k, stored PRE-ROTATED in ring-stage order so
    `RingSync` stage s reads chunk s with a static index
  * replica synchronisation disappears: a `lax.ppermute` ring rotates the
    feature blocks instead (k-1 stages of (Vb+1)*d elements per device),
    each stage's local segment-SpMM over one chunk overlapping the next
    block's transfer (gnn/sync.py:RingSync).

TPU adaptation (DESIGN.md §2): DistGNN's MPI alltoallv becomes a fixed-bucket
`lax.all_to_all` because XLA SPMD requires static shapes; the partition is
known before tracing so the routing is static. Padding waste = (B * k / true
pair volume) is reported by `EdgePartitionBook.padding_waste()`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.kernels.tiling import (
    prepare_tiled_edges,
    tiled_need_per_tile,
    tiled_shape,
)

__all__ = [
    "BlockRowBook",
    "EdgePartitionBook",
    "VertexPartitionBook",
    "build_blockrow_book",
    "build_edge_book",
    "build_vertex_book",
]


@dataclasses.dataclass(frozen=True)
class EdgePartitionBook:
    k: int
    num_vertices: int
    v_max: int  # max local vertices (excl. dummy row)
    e_max: int
    bucket: int  # B: all_to_all bucket (max replica list over ordered pairs)

    # [k, v_max+1]: global id per local slot (pad/dummy -> -1)
    vglobal: np.ndarray
    # [k, v_max+1] bool: local slot holds a real vertex
    vmask: np.ndarray
    # [k, v_max+1] bool: this partition is the master of the local vertex
    master: np.ndarray
    # [k, v_max+1] float32: *global* degree of the local vertex (for GCN/mean)
    degree: np.ndarray
    # [k, e_max] int32 local endpoint indices; pad -> v_max (dummy row)
    esrc: np.ndarray
    edst: np.ndarray
    # [k, e_max] bool
    emask: np.ndarray

    # routing — reduce phase: device i sends h[A[i, j]] to j; j scatters into
    # C[j, i]. broadcast phase is the exact transpose.
    # [k, k, bucket] int32 local indices (pad -> v_max) and bool masks
    send_idx: np.ndarray   # A
    send_mask: np.ndarray
    recv_idx: np.ndarray   # C
    recv_mask: np.ndarray

    replicas_total: int  # sum over pairs of true replica-list lengths

    # tiled aggregation layout (kernels.tiling.prepare_tiled_edges, built
    # with the DEFAULT_TILE_V/DEFAULT_BLOCK_E tiling `ops.aggregate` expects)
    # over the SYMMETRISED edge list — dst sequence [edst | esrc], one layout
    # per partition, padded to a uniform per-tile edge count so the stacked
    # [k, ...] arrays share one static shape. Masked (padding) edges are
    # dropped: their messages are identically zero. Empty [k, 0] unless the
    # book was built with tiled_layout=True.
    # [k, E_tiled] gather indices into the 2*e_max message list (pad -> 2*e_max)
    agg_order: np.ndarray
    # [k, E_tiled] row id within the edge's row tile (pad -> DEFAULT_TILE_V)
    agg_ldst: np.ndarray

    def padding_waste(self) -> float:
        """Fraction of all_to_all payload that is padding (0 = perfect)."""
        payload = self.k * self.k * self.bucket
        if payload == 0:
            return 0.0
        return 1.0 - self.replicas_total / payload

    def master_assignment(self) -> np.ndarray:
        """Per-vertex master partition as an int32 [V] ownership array.

        This is the vertex-partition view of an edge partition: exactly one
        master per vertex, so the result is a valid `VertexPartitionBook`
        assignment — how the inference serving path shards its embedding
        stores when the graph was partitioned by edges.
        """
        owner = np.zeros(self.num_vertices, dtype=np.int32)
        sel = self.master & self.vmask
        part_of = np.broadcast_to(
            np.arange(self.k, dtype=np.int32)[:, None], self.master.shape)
        owner[self.vglobal[sel]] = part_of[sel]
        return owner

    def local_features(self, features: np.ndarray) -> np.ndarray:
        """Replicate global features [V, F] into [k, v_max+1, F] device layout."""
        f = np.zeros((self.k, self.v_max + 1, features.shape[1]), dtype=features.dtype)
        safe = np.where(self.vglobal >= 0, self.vglobal, 0)
        f[:] = features[safe]
        f[~self.vmask] = 0
        return f

    def local_labels(self, labels: np.ndarray, fill: int = -1) -> np.ndarray:
        out = np.full((self.k, self.v_max + 1), fill, dtype=np.int32)
        safe = np.where(self.vglobal >= 0, self.vglobal, 0)
        out[:] = labels[safe]
        out[~self.vmask] = fill
        return out

    def scatter_to_global(self, local: np.ndarray) -> np.ndarray:
        """Collect master rows back into a global [V, ...] array (host-side)."""
        out_shape = (self.num_vertices,) + local.shape[2:]
        out = np.zeros(out_shape, dtype=local.dtype)
        sel = self.master & self.vmask
        out[self.vglobal[sel]] = local[sel]
        return out


def build_edge_book(
    graph: Graph,
    edge_assignment: np.ndarray,
    k: int,
    *,
    tiled_layout: bool = False,
) -> EdgePartitionBook:
    """`tiled_layout` additionally builds the per-partition tiled aggregation
    layout (agg_order/agg_ldst) — only the tiled/pallas backends read it, so
    the default scatter path skips the host sort and the device residency
    (the fields are then empty [k, 0] arrays)."""
    assignment = np.asarray(edge_assignment, dtype=np.int64)
    V = graph.num_vertices
    src = graph.src.astype(np.int64)
    dst = graph.dst.astype(np.int64)

    # --- cover pairs (p, v), with incident-edge counts for master election --
    pv = np.concatenate([assignment * V + src, assignment * V + dst])
    pv_unique, counts = np.unique(pv, return_counts=True)
    pp = (pv_unique // V).astype(np.int64)
    vv = (pv_unique % V).astype(np.int64)

    # local index of each (p, v): rank within its partition
    part_sizes = np.bincount(pp, minlength=k)
    v_max = int(part_sizes.max()) if part_sizes.size else 0
    part_starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(part_sizes, out=part_starts[1:])
    local_idx = np.arange(pv_unique.shape[0]) - part_starts[pp]

    vglobal = np.full((k, v_max + 1), -1, dtype=np.int64)
    vglobal[pp, local_idx] = vv
    vmask = vglobal >= 0

    # --- master election: replica with most incident edges, tie -> lowest p -
    # sort by (v, -count, p); first row per v wins
    order = np.lexsort((pp, -counts, vv))
    v_sorted = vv[order]
    first = np.ones(v_sorted.shape[0], dtype=bool)
    first[1:] = v_sorted[1:] != v_sorted[:-1]
    master_of = np.full(V, -1, dtype=np.int64)
    master_of[v_sorted[first]] = pp[order][first]

    master = np.zeros((k, v_max + 1), dtype=bool)
    is_master_pair = master_of[vv] == pp
    master[pp[is_master_pair], local_idx[is_master_pair]] = True

    # --- degrees (global, for normalisation on device) ----------------------
    # GNN aggregation runs over the symmetrised adjacency (DGL semantics on
    # undirected training graphs), so the normaliser is the symmetric degree.
    deg_global = graph.degrees().astype(np.float32)
    degree = np.zeros((k, v_max + 1), dtype=np.float32)
    degree[pp, local_idx] = deg_global[vv]

    # --- edge endpoint local indices ----------------------------------------
    # lookup (p, v) -> local via searchsorted on the sorted pv_unique keys
    def lookup(p: np.ndarray, v: np.ndarray) -> np.ndarray:
        keys = p * V + v
        pos = np.searchsorted(pv_unique, keys)
        return local_idx[pos]

    e_sizes = np.bincount(assignment, minlength=k)
    e_max = int(e_sizes.max()) if e_sizes.size else 0
    e_starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(e_sizes, out=e_starts[1:])
    e_order = np.argsort(assignment, kind="stable")
    e_local = np.arange(graph.num_edges) - e_starts[assignment[e_order]]

    esrc = np.full((k, e_max), v_max, dtype=np.int64)
    edst = np.full((k, e_max), v_max, dtype=np.int64)
    emask = np.zeros((k, e_max), dtype=bool)
    pe = assignment[e_order]
    esrc[pe, e_local] = lookup(pe, src[e_order])
    edst[pe, e_local] = lookup(pe, dst[e_order])
    emask[pe, e_local] = True

    # --- halo routing: mirrors -> masters ------------------------------------
    mirror_pairs = ~is_master_pair  # (p, v) where p is a mirror
    mi = pp[mirror_pairs]                 # sender (mirror) partition
    mv = vv[mirror_pairs]                 # vertex
    mj = master_of[mv]                    # receiver (master) partition
    m_local_send = local_idx[mirror_pairs]          # local idx at sender
    m_local_recv = lookup(mj, mv)                   # local idx at master

    # group by (i, j)
    pair_key = mi * k + mj
    order2 = np.argsort(pair_key, kind="stable")
    pk_sorted = pair_key[order2]
    pair_sizes = np.bincount(pk_sorted, minlength=k * k)
    bucket = int(pair_sizes.max()) if pair_sizes.size and pair_sizes.max() > 0 else 1
    pair_starts = np.zeros(k * k + 1, dtype=np.int64)
    np.cumsum(pair_sizes, out=pair_starts[1:])
    within = np.arange(pk_sorted.shape[0]) - pair_starts[pk_sorted]

    send_idx = np.full((k, k, bucket), v_max, dtype=np.int64)
    send_mask = np.zeros((k, k, bucket), dtype=bool)
    recv_idx = np.full((k, k, bucket), v_max, dtype=np.int64)
    recv_mask = np.zeros((k, k, bucket), dtype=bool)

    si = pk_sorted // k
    sj = pk_sorted % k
    send_idx[si, sj, within] = m_local_send[order2]
    send_mask[si, sj, within] = True
    recv_idx[sj, si, within] = m_local_recv[order2]
    recv_mask[sj, si, within] = True

    # --- tiled aggregation layout (one per partition, uniform shape) --------
    # The device aggregates over the symmetrised edge list: messages are
    # [values_src | values_dst] with destinations [edst | esrc]. Masked edges
    # carry zero messages and are dropped from the layout.
    if tiled_layout:
        dst2 = np.concatenate([edst, esrc], axis=1)
        valid2 = np.concatenate([emask, emask], axis=1)
        _, n_tiles = tiled_shape(v_max + 1)
        per_tile = max(
            tiled_need_per_tile(dst2[p], v_max + 1, valid=valid2[p])
            for p in range(k)
        )
        agg_order = np.empty((k, per_tile * n_tiles), dtype=np.int64)
        agg_ldst = np.empty((k, per_tile * n_tiles), dtype=np.int32)
        for p in range(k):
            agg_order[p], agg_ldst[p], _ = prepare_tiled_edges(
                dst2[p], v_max + 1, per_tile=per_tile, valid=valid2[p],
            )
    else:
        agg_order = np.zeros((k, 0), dtype=np.int64)
        agg_ldst = np.zeros((k, 0), dtype=np.int32)

    return EdgePartitionBook(
        k=k,
        num_vertices=V,
        v_max=v_max,
        e_max=e_max,
        bucket=bucket,
        vglobal=vglobal,
        vmask=vmask,
        master=master,
        degree=degree,
        esrc=esrc.astype(np.int32),
        edst=edst.astype(np.int32),
        emask=emask,
        send_idx=send_idx.astype(np.int32),
        send_mask=send_mask,
        recv_idx=recv_idx.astype(np.int32),
        recv_mask=recv_mask,
        replicas_total=int(mirror_pairs.sum()),
        agg_order=agg_order.astype(np.int32),
        agg_ldst=agg_ldst,
    )


# ---------------------------------------------------------------------------
# Vertex partition book (DistDGL regime)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class VertexPartitionBook:
    k: int
    num_vertices: int
    owner: np.ndarray          # int32 [V]
    v_max: int                 # max owned vertices per partition
    vglobal: np.ndarray        # [k, v_max] global ids of owned vertices (pad -1)
    local_of: np.ndarray       # int64 [V]: local slot of each vertex at owner
    sizes: np.ndarray          # int64 [k]

    def feature_shards(self, features: np.ndarray) -> np.ndarray:
        """[k, v_max, F] owner-sharded features (DistDGL KV-store layout)."""
        out = np.zeros((self.k, self.v_max, features.shape[1]), dtype=features.dtype)
        safe = np.where(self.vglobal >= 0, self.vglobal, 0)
        out[:] = features[safe]
        out[self.vglobal < 0] = 0
        return out


# ---------------------------------------------------------------------------
# Block-row book (1.5D / CAGNET regime)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BlockRowBook:
    """Static 1.5D layout: contiguous vertex blocks + ring-ordered edge chunks.

    Row layout mirrors `EdgePartitionBook`'s device block (dummy row at index
    `v_block`), so the same model code runs on both; the halo routing tables
    are replaced by the chunk arrays `RingSync` consumes.
    """

    k: int
    num_vertices: int
    v_block: int   # rows per block, ceil(V / k); local row v_block = dummy
    c_max: int     # uniform per-chunk edge capacity (max over k*k chunks)

    # [k, v_block+1]: global id per local slot (pad/dummy -> -1)
    vglobal: np.ndarray
    vmask: np.ndarray    # [k, v_block+1] bool
    degree: np.ndarray   # [k, v_block+1] float32 global symmetric degree

    # ring chunks over the SYMMETRISED directed edge list (each stored edge
    # (u, v) contributes u->v and v->u; 2E directed edges total), pre-rotated:
    # chunk (p, s) holds the directed edges with dst in block p and src in
    # block (p+s) mod k. chunk_esrc indexes the VISITING payload block's rows,
    # chunk_edst the local (own) rows; pad -> v_block (dummy row).
    chunk_esrc: np.ndarray   # [k, k, c_max] int32
    chunk_edst: np.ndarray   # [k, k, c_max] int32
    chunk_emask: np.ndarray  # [k, k, c_max] bool

    # per-chunk tiled aggregation layouts (kernels.tiling.prepare_tiled_edges
    # over chunk_edst with valid=chunk_emask, one shared per_tile so all k*k
    # chunks stack to one static shape). Empty [k, k, 0] unless the book was
    # built with tiled_layout=True.
    chunk_agg_order: np.ndarray  # [k, k, E_tiled] int32 (pad -> c_max)
    chunk_agg_ldst: np.ndarray   # [k, k, E_tiled] int32 (pad -> tile_v)

    # masters == vmask: every vertex lives exactly once, on its block row
    @property
    def master(self) -> np.ndarray:
        return self.vmask

    def local_features(self, features: np.ndarray) -> np.ndarray:
        """Block global features [V, F] into [k, v_block+1, F] device layout."""
        f = np.zeros((self.k, self.v_block + 1, features.shape[1]),
                     dtype=features.dtype)
        safe = np.where(self.vglobal >= 0, self.vglobal, 0)
        f[:] = features[safe]
        f[~self.vmask] = 0
        return f

    def local_labels(self, labels: np.ndarray, fill: int = -1) -> np.ndarray:
        out = np.full((self.k, self.v_block + 1), fill, dtype=np.int32)
        safe = np.where(self.vglobal >= 0, self.vglobal, 0)
        out[:] = labels[safe]
        out[~self.vmask] = fill
        return out

    def scatter_to_global(self, local: np.ndarray) -> np.ndarray:
        """Collect block rows back into a global [V, ...] array (host-side)."""
        out_shape = (self.num_vertices,) + local.shape[2:]
        out = np.zeros(out_shape, dtype=local.dtype)
        out[self.vglobal[self.vmask]] = local[self.vmask]
        return out


def build_blockrow_book(
    graph: Graph,
    k: int,
    *,
    tiled_layout: bool = False,
) -> BlockRowBook:
    """1.5D book: contiguous vertex blocks, symmetrised edges chunked by
    (dst block, ring stage). `tiled_layout` additionally builds one
    `prepare_tiled_edges` layout per chunk (shared per_tile, so the stacked
    [k, k, ...] arrays have one static shape) for the tiled/pallas backends."""
    V = graph.num_vertices
    v_block = -(-max(V, 1) // k)  # ceil(V / k)

    vglobal = np.full((k, v_block + 1), -1, dtype=np.int64)
    ids = np.arange(V, dtype=np.int64)
    vglobal[ids // v_block, ids % v_block] = ids
    vmask = vglobal >= 0

    deg_global = graph.degrees().astype(np.float32)
    degree = np.zeros((k, v_block + 1), dtype=np.float32)
    degree[ids // v_block, ids % v_block] = deg_global

    # symmetrised directed edge list: u->v and v->u per stored edge
    ssrc = np.concatenate([graph.src, graph.dst]).astype(np.int64)
    sdst = np.concatenate([graph.dst, graph.src]).astype(np.int64)
    own = sdst // v_block            # owning block row (by destination)
    sblk = ssrc // v_block           # source block (the visiting payload)
    stage = (sblk - own) % k         # ring stage that sees this edge

    key = own * k + stage
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    sizes = np.bincount(key_sorted, minlength=k * k)
    c_max = int(max(sizes.max() if sizes.size else 0, 1))
    starts = np.zeros(k * k + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    within = np.arange(key_sorted.shape[0]) - starts[key_sorted]

    chunk_esrc = np.full((k, k, c_max), v_block, dtype=np.int32)
    chunk_edst = np.full((k, k, c_max), v_block, dtype=np.int32)
    chunk_emask = np.zeros((k, k, c_max), dtype=bool)
    cp = key_sorted // k
    cs = key_sorted % k
    chunk_esrc[cp, cs, within] = (ssrc[order] % v_block).astype(np.int32)
    chunk_edst[cp, cs, within] = (sdst[order] % v_block).astype(np.int32)
    chunk_emask[cp, cs, within] = True

    if tiled_layout:
        n_rows = v_block + 1
        _, n_tiles = tiled_shape(n_rows)
        per_tile = max(
            tiled_need_per_tile(chunk_edst[p, s], n_rows,
                                valid=chunk_emask[p, s])
            for p in range(k) for s in range(k)
        )
        e_tiled = per_tile * n_tiles
        chunk_agg_order = np.empty((k, k, e_tiled), dtype=np.int64)
        chunk_agg_ldst = np.empty((k, k, e_tiled), dtype=np.int32)
        for p in range(k):
            for s in range(k):
                chunk_agg_order[p, s], chunk_agg_ldst[p, s], _ = (
                    prepare_tiled_edges(
                        chunk_edst[p, s], n_rows, per_tile=per_tile,
                        valid=chunk_emask[p, s],
                    ))
    else:
        chunk_agg_order = np.zeros((k, k, 0), dtype=np.int64)
        chunk_agg_ldst = np.zeros((k, k, 0), dtype=np.int32)

    return BlockRowBook(
        k=k,
        num_vertices=V,
        v_block=v_block,
        c_max=c_max,
        vglobal=vglobal,
        vmask=vmask,
        degree=degree,
        chunk_esrc=chunk_esrc,
        chunk_edst=chunk_edst,
        chunk_emask=chunk_emask,
        chunk_agg_order=chunk_agg_order.astype(np.int32),
        chunk_agg_ldst=chunk_agg_ldst,
    )


def build_vertex_book(graph: Graph, vertex_assignment: np.ndarray, k: int) -> VertexPartitionBook:
    owner = np.asarray(vertex_assignment, dtype=np.int32)
    sizes = np.bincount(owner, minlength=k).astype(np.int64)
    v_max = int(sizes.max()) if sizes.size else 0
    order = np.argsort(owner, kind="stable")
    starts = np.zeros(k + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    local = np.arange(graph.num_vertices, dtype=np.int64) - starts[owner[order]]
    local_of = np.empty(graph.num_vertices, dtype=np.int64)
    local_of[order] = local
    vglobal = np.full((k, v_max), -1, dtype=np.int64)
    vglobal[owner[order], local] = order
    return VertexPartitionBook(
        k=k,
        num_vertices=graph.num_vertices,
        owner=owner,
        v_max=v_max,
        vglobal=vglobal,
        local_of=local_of,
        sizes=sizes,
    )

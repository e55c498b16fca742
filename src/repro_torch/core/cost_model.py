# Copy of the serving, full-batch, mini-batch and recovery parts of
# repro/core/cost_model.py (NumPy, with the port's wire codecs).
# tests/test_torch_host.py, tests/test_torch_sync.py,
# tests/test_torch_wire.py and tests/test_torch_fault.py hold
# `serve_request`, `fullbatch_epoch` (edge and block-row books),
# `ring_bytes_per_round`, `minibatch_step`, `overlapped_step_time`,
# `collective_budget` and `recovery_time` equal to the originals.
"""Cluster cost model — prices one serving micro-batch, one full-batch
training epoch and one mini-batch training step on the paper's 32-machine
cluster (§3: 8-core Haswell 2.4 GHz, 64 GB RAM).

The inputs (per-partition edges, vertices and replica rows; per-batch
input vertices, remote vertices, cache misses, MFG edges) are measured
from the real partition books and sampled batches; only the hardware
constants below are assumed. These are modeled times for the paper's
cluster, not times of the device the port runs on. Every estimate takes a
wire `codec` (core/wire.py) and prices the encoded bytes beside the
logical ones; the fp32 default prices 4 bytes an element, bit for bit the
codec-free model.

Conventions: times in seconds, sizes in bytes, rates in bytes/s or flop/s.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np

from repro_torch.core.partition_book import BlockRowBook
from repro_torch.core.wire import as_codec
# re-exported so every analytic communication quantity comes from one module
from repro_torch.gnn.sync import collective_budget

if TYPE_CHECKING:
    from repro_torch.gnn.models import GNNSpec

__all__ = ["ClusterSpec", "FullBatchEstimate", "MiniBatchEstimate",
           "PAPER_CLUSTER", "RecoveryEstimate", "ServeEstimate",
           "collective_budget", "fullbatch_epoch", "minibatch_step",
           "overlapped_step_time", "recovery_time", "ring_bytes_per_round",
           "serve_request"]


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """Hardware constants for one machine + interconnect."""

    name: str
    flops: float          # effective dense flop/s per machine
    mem_bw: float         # bytes/s effective memory bandwidth (sparse agg)
    net_bw: float         # bytes/s per-machine network bandwidth
    net_latency: float    # seconds per collective round
    memory: float         # bytes of RAM per machine
    sample_rate: float    # sampled edges/s per machine (host sampler)
    remote_adj_cost: float  # seconds per remote vertex adjacency access
    sample_hop_overhead: float = 5e-4  # fixed per-hop cost (RPC round, batching)
    disk_bw: float = 500e6      # bytes/s checkpoint restore read bandwidth
    recompile_s: float = 30.0   # seconds to re-trace + re-compile the step


# Paper cluster: 8-core 2.4 GHz Haswell. Dense f32 peak would be
# ~614 GFLOP/s; GNN kernels on DGL reach a few percent of peak, so we use an
# effective 40 GFLOP/s. 10 GbE assumed (not stated in the paper): 1.25 GB/s.
PAPER_CLUSTER = ClusterSpec(
    name="paper-32x-haswell",
    flops=40e9,
    mem_bw=12e9,
    net_bw=1.25e9,
    net_latency=150e-6,
    memory=64e9,
    sample_rate=2e7,
    remote_adj_cost=2e-7,
    sample_hop_overhead=5e-4,
)


def _flops_per_vertex_dims(model: str, dims) -> float:
    """Dense NN flops per vertex for one forward pass over `dims` layers."""
    total = 0.0
    for din, dout in dims:
        if model == "sage":
            total += 2.0 * din * dout * 2  # self + neigh matmuls
        elif model == "gcn":
            total += 2.0 * din * dout
        else:  # gat
            total += 2.0 * din * dout + 8.0 * dout
    return total


def _model_flops_per_vertex(spec: "GNNSpec") -> float:
    """Dense NN flops per vertex for one forward pass (all layers)."""
    return _flops_per_vertex_dims(spec.model, spec.dims())


def _agg_bytes_per_edge(spec: "GNNSpec") -> float:
    """Bytes moved per edge per layer for the aggregation (read msg + write)."""
    dims = [spec.feature_dim] + [spec.hidden_dim] * (spec.num_layers - 1)
    return float(sum(3 * 4 * d for d in dims))


def _wire_elem(codec, layer: int = 0) -> float:
    """Wire bytes of one f32 logical element under `codec` at aggregate
    ordinal `layer`. The per-tensor meta (int8's scale) is dropped at this
    granularity; `Codec.wire_bytes` and `gnn.sync.sync_wire_bytes_per_round`
    count it. Exactly 4.0 under fp32."""
    return 4.0 * as_codec(codec).ratio(layer)


@dataclasses.dataclass(frozen=True)
class FullBatchEstimate:
    epoch_time: float
    compute_time: np.ndarray     # [k] per machine
    comm_time: np.ndarray        # [k]
    comm_bytes: np.ndarray       # [k] true (unpadded) replica-sync traffic
    memory: np.ndarray           # [k] bytes
    oom: bool
    # [k] encoded bytes crossing the network under the codec the estimate
    # was priced with; == comm_bytes for fp32
    wire_bytes: Optional[np.ndarray] = None


def ring_bytes_per_round(book: BlockRowBook, d: int) -> int:
    """Cluster-wide `ppermute` bytes of ONE ring aggregate at width d.

    k−1 stages, each device shipping its [Vb+1, d] f32 payload block:
    k·(k−1)·(Vb+1)·d·4 bytes. Independent of graph structure — the 1.5D
    regime trades the replication-factor sensitivity of halo for a fixed
    (k−1)/k · V·d volume (< dense's 2·V·d at every k). Matches
    `gnn.sync.sync_bytes_per_round(book, d, "ring")`.
    """
    return book.k * (book.k - 1) * (book.v_block + 1) * d * 4


def _ring_epoch(
    book: BlockRowBook,
    spec: "GNNSpec",
    cluster: ClusterSpec,
    codec=None,
) -> FullBatchEstimate:
    """Overlap-aware 1.5D ring epoch estimate.

    Each aggregate is k stages of per-chunk segment-SpMM with the next
    block's `ppermute` in flight: a stage's transfer is hidden when the
    chunk compute covers it, so per aggregate
        time = k·c_stage + (k−1)·max(0, t_stage − c_stage)
    and only the uncovered remainder shows up as comm_time.
    """
    k = book.k
    edges = book.chunk_emask.sum(axis=(1, 2)).astype(np.float64)
    verts = book.vmask.sum(axis=1).astype(np.float64)

    # chunk_emask already counts BOTH directions of every stored edge, while
    # _agg_bytes_per_edge prices a stored (bidirectional) edge — halve.
    agg_bytes = edges / 2.0 * _agg_bytes_per_edge(spec) * 3.0
    nn_flops = verts * _model_flops_per_vertex(spec) * 3.0
    compute = agg_bytes / cluster.mem_bw + nn_flops / cluster.flops

    dims = [dout for _, dout in spec.dims()]
    aggs_per_layer = 3 if spec.model == "gat" else 1
    syncs = aggs_per_layer * 2  # per layer, fwd+bwd
    stage_rows = float(book.v_block + 1)
    comm_bytes = np.full(k, (k - 1) * stage_rows * 4 * sum(dims) * syncs)
    wire_bytes = np.zeros(k)
    for li, d in enumerate(dims):
        eb = _wire_elem(codec, li * aggs_per_layer)
        wire_bytes += (k - 1) * stage_rows * eb * d * syncs
    comm = np.zeros(k)
    if k > 1:
        for li, d in enumerate(dims):
            eb = _wire_elem(codec, li * aggs_per_layer)
            t_stage = (stage_rows * d * eb / cluster.net_bw
                       + cluster.net_latency)
            # per-stage chunk compute: this layer's aggregation share of the
            # memory-bound traffic, spread over the k chunks
            layer_frac = 3 * 4 * d / _agg_bytes_per_edge(spec)
            c_stage = agg_bytes * layer_frac / cluster.mem_bw / k
            exposed = np.maximum(0.0, t_stage - c_stage) * (k - 1)
            comm += exposed * syncs
    f, h, L = spec.feature_dim, spec.hidden_dim, spec.num_layers
    memory = (
        verts * f * 4
        + verts * h * 4 * L * 2
        + edges * 4
        + 2 * stage_rows * max(f, h) * 4  # double-buffered rotation payload
    )
    epoch = float((compute + comm).max())
    return FullBatchEstimate(
        epoch_time=epoch,
        compute_time=compute,
        comm_time=comm,
        comm_bytes=comm_bytes,
        memory=memory,
        oom=bool((memory > cluster.memory).any()),
        wire_bytes=wire_bytes,
    )


def fullbatch_epoch(
    book,
    spec: "GNNSpec",
    cluster: ClusterSpec = PAPER_CLUSTER,
    codec=None,
) -> FullBatchEstimate:
    """Full-batch epoch estimate from a real partition book.

    EdgePartitionBook (DistGNN/halo regime) —
    Compute: aggregation is memory-bound over local edges; vertex updates are
    dense flops over local (replicated!) vertices — so *vertex imbalance*
    directly skews compute, exactly the paper's §4.2(2) observation.
    Communication: true per-partition replica-sync volume (alltoallv on the
    paper's cluster — no bucket padding), reduce + broadcast per layer,
    forward + backward.

    BlockRowBook (1.5D ring regime) — see `_ring_epoch`: fixed rotation
    volume with the transfer overlapped against per-chunk compute.
    """
    if isinstance(book, BlockRowBook):
        return _ring_epoch(book, spec, cluster, codec)
    k = book.k
    edges = book.emask.sum(axis=1).astype(np.float64)
    verts = book.vmask.sum(axis=1).astype(np.float64)

    # fwd + bwd ~ 3x forward cost (standard rule of thumb)
    agg_bytes = edges * _agg_bytes_per_edge(spec) * 3.0
    nn_flops = verts * _model_flops_per_vertex(spec) * 3.0
    compute = agg_bytes / cluster.mem_bw + nn_flops / cluster.flops

    # per-partition sync volume: rows it sends (as mirror) + rows it returns
    # (as master) = send_mask + recv_mask true counts, per layer/round.
    send_rows = book.send_mask.sum(axis=(1, 2)).astype(np.float64)
    recv_rows = book.recv_mask.sum(axis=(1, 2)).astype(np.float64)
    dims = [dout for _, dout in spec.dims()]
    aggs_per_layer = 3 if spec.model == "gat" else 1
    syncs = aggs_per_layer * 2  # per layer, fwd+bwd
    rows = send_rows + recv_rows
    comm_bytes = np.zeros(k)
    wire_bytes = np.zeros(k)
    for li, d in enumerate(dims):
        comm_bytes += rows * d * 4 * syncs
        wire_bytes += rows * d * _wire_elem(codec, li * aggs_per_layer) * syncs
    comm = wire_bytes / cluster.net_bw + cluster.net_latency * 2 * len(dims) * syncs

    # memory: features + per-layer activations (kept for backward) + graph
    f, h, L = spec.feature_dim, spec.hidden_dim, spec.num_layers
    memory = (
        verts * f * 4
        + verts * h * 4 * L * 2
        + edges * 8
        + rows * max(f, h) * 4
    )
    epoch = float((compute + comm).max())
    return FullBatchEstimate(
        epoch_time=epoch,
        compute_time=compute,
        comm_time=comm,
        comm_bytes=comm_bytes,
        memory=memory,
        oom=bool((memory > cluster.memory).any()),
        wire_bytes=wire_bytes,
    )


@dataclasses.dataclass(frozen=True)
class MiniBatchEstimate:
    step_time: float          # serial phases: straggler host+compute + allreduce
    sample_time: np.ndarray   # [k]
    fetch_time: np.ndarray    # [k]
    compute_time: np.ndarray  # [k]
    fetch_bytes: np.ndarray   # [k]
    straggler: int            # argmax worker
    memory: np.ndarray        # [k]
    allreduce_time: float = 0.0  # gradient all-reduce (shared by both modes)
    # [k] encoded feature-fetch bytes on the wire under the pricing codec;
    # == fetch_bytes for fp32
    wire_bytes: Optional[np.ndarray] = None


def minibatch_step(
    input_vertices: np.ndarray,
    remote_vertices: np.ndarray,
    edges: np.ndarray,
    owned_vertices: np.ndarray,
    spec: "GNNSpec",
    cluster: ClusterSpec = PAPER_CLUSTER,
    seeds_per_worker: int = 64,
    *,
    remote_miss_vertices: Optional[np.ndarray] = None,
    cached_vertices: Optional[np.ndarray] = None,
    codec=None,
) -> MiniBatchEstimate:
    """DistDGL step estimate from real per-worker sampled-batch metrics.

    The paper's phase structure: sampling (host; remote adjacency accesses
    cost network latency), feature loading (remote vertices cross the
    network), forward+backward (dense flops on the sampled block), update
    (negligible). Step time = slowest worker (straggler) + gradient
    all-reduce.

    With a per-worker feature cache (gnn/feature_store.py), only cache
    *misses* cross the network: pass `remote_miss_vertices` [k] to price the
    fetch phase from missed bytes (default: every remote vertex misses, the
    uncached DistDGL behavior) and `cached_vertices` [k] to charge the cache
    copies to worker memory. Sampling still pays `remote_vertices` adjacency
    costs — the cache holds features, not adjacency.
    """
    input_vertices = input_vertices.astype(np.float64)
    remote = remote_vertices.astype(np.float64)
    edges = edges.astype(np.float64)
    miss = (remote if remote_miss_vertices is None
            else remote_miss_vertices.astype(np.float64))

    sample = (edges / cluster.sample_rate + remote * cluster.remote_adj_cost
              + cluster.sample_hop_overhead * spec.num_layers)
    fetch_bytes = miss * spec.feature_dim * 4
    wire_bytes = miss * spec.feature_dim * _wire_elem(codec)
    fetch = wire_bytes / cluster.net_bw + cluster.net_latency

    # dense flops: each sampled edge moves a d-dim message once per layer;
    # each block vertex gets the per-vertex NN update.
    nn = input_vertices * _model_flops_per_vertex(spec) * 3.0
    agg = edges * 2.0 * max(spec.feature_dim, spec.hidden_dim) * 3.0
    compute = (nn + agg) / cluster.flops

    per_worker = sample + fetch + compute
    straggler = int(np.argmax(per_worker))

    n_params = sum(din * dout for din, dout in spec.dims()) * 2
    allreduce = (2 * n_params * _wire_elem(codec) / cluster.net_bw
                 + cluster.net_latency)

    f = spec.feature_dim
    memory = (
        owned_vertices.astype(np.float64) * f * 4          # local feature shard
        + input_vertices * f * 4                            # fetched cache
        + input_vertices * spec.hidden_dim * 4 * spec.num_layers * 2
    )
    if cached_vertices is not None:                        # static feature cache
        memory = memory + cached_vertices.astype(np.float64) * f * 4
    return MiniBatchEstimate(
        step_time=float(per_worker.max() + allreduce),
        sample_time=sample,
        fetch_time=fetch,
        compute_time=compute,
        fetch_bytes=fetch_bytes,
        straggler=straggler,
        memory=memory,
        allreduce_time=float(allreduce),
        wire_bytes=wire_bytes,
    )


def overlapped_step_time(est: MiniBatchEstimate) -> float:
    """Pipelined step time from a serial `minibatch_step` estimate.

    Prefetch (gnn/pipeline.py) hides the host phases behind device compute,
    so in steady state each worker's step costs max(sample + fetch, compute)
    instead of their sum; the cluster step is still gated by the slowest
    worker plus the gradient all-reduce, which no prefetch hides. The
    model-side twin of the measured `StepMetrics.overlap_efficiency`."""
    host = est.sample_time + est.fetch_time
    return float(np.maximum(host, est.compute_time).max() + est.allreduce_time)


@dataclasses.dataclass(frozen=True)
class ServeEstimate:
    """Cluster service time of ONE micro-batch at one worker."""

    service_time: float   # sample + fetch + compute (serial per worker)
    sample_time: float
    fetch_time: float
    compute_time: float
    fetch_bytes: int      # embedding-store MISS bytes, logical (f32) size
    wire_bytes: int = 0   # encoded MISS bytes; == fetch_bytes under fp32


def serve_request(
    num_input: float,
    num_remote: float,
    num_miss: float,
    edges: float,
    spec: "GNNSpec",
    *,
    embed_dim: int,
    hops: int,
    cluster: ClusterSpec = PAPER_CLUSTER,
    codec=None,
) -> ServeEstimate:
    """Price one serving micro-batch from its measured MFG + store metrics:
    sampling the `hops`-deep MFG (remote adjacency accesses cost network
    latency), fetching the cache-MISS embedding rows (`embed_dim` elements
    each, at the codec's wire bytes an element) and recomputing the last
    `hops` layers, forward only."""
    num_input = float(num_input)
    edges = float(edges)
    sample = (edges / cluster.sample_rate
              + float(num_remote) * cluster.remote_adj_cost
              + cluster.sample_hop_overhead * hops)
    fetch_bytes = int(num_miss) * embed_dim * 4
    wire_bytes = int(round(int(num_miss) * embed_dim * _wire_elem(codec)))
    fetch = wire_bytes / cluster.net_bw + cluster.net_latency

    # forward-only dense flops over the recomputed layer suffix
    dims = spec.dims()[spec.num_layers - hops:]
    nn = num_input * _flops_per_vertex_dims(spec.model, dims)
    width = max([embed_dim] + [dout for _, dout in dims])
    agg = edges * 2.0 * width
    compute = (nn + agg) / cluster.flops

    return ServeEstimate(
        service_time=sample + fetch + compute,
        sample_time=sample,
        fetch_time=fetch,
        compute_time=compute,
        fetch_bytes=fetch_bytes,
        wire_bytes=wire_bytes,
    )


# ---------------------------------------------------------------------------
# failure recovery
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryEstimate:
    """Cluster cost of one recovery: restore + re-partition + re-compile.

    The three terms are the paper-cluster price of what elastic recovery
    actually does (fault/recovery.py): read the checkpoint back from the
    shared filesystem, re-run the partitioner for the new worker count, and
    re-trace/re-compile the step function for the new mesh shape. This is
    the amortization question (tab3) extended to failures: a high-quality
    partitioner's epoch-time advantage must now also pay back its
    re-partition cost every time recovery forces one.
    """

    restore_time: float       # checkpoint read: bytes / disk_bw + latency
    repartition_time: float   # measured host partitioner wall (real data)
    recompile_time: float     # XLA re-trace + re-compile for the new mesh

    @property
    def recovery_time(self) -> float:
        return self.restore_time + self.repartition_time + self.recompile_time


def recovery_time(
    ckpt_bytes: float,
    partition_time: float,
    *,
    cluster: ClusterSpec = PAPER_CLUSTER,
    compile_time: Optional[float] = None,
) -> RecoveryEstimate:
    """Price one recovery. `ckpt_bytes` is the checkpointable state volume
    (params + opt state + EF carry); `partition_time` is the MEASURED
    re-partition wall (the partitioners run for real here, exactly like the
    partition_time column of every study row); `compile_time` overrides the
    cluster's re-compile constant when a measured value exists."""
    restore = cluster.net_latency + float(ckpt_bytes) / cluster.disk_bw
    return RecoveryEstimate(
        restore_time=restore,
        repartition_time=float(partition_time),
        recompile_time=(cluster.recompile_s if compile_time is None
                        else float(compile_time)),
    )

# Copy of the serving part of repro/core/cost_model.py (NumPy only), fp32
# wire only. tests/test_torch_host.py holds `serve_request` equal to the
# original.
"""Cluster cost model — prices one serving micro-batch on the paper's
32-machine cluster (§3: 8-core Haswell 2.4 GHz, 64 GB RAM).

The per-batch inputs (input vertices, remote vertices, cache misses, MFG
edges) are measured from the real sampled batches; only the hardware
constants below are assumed. These are modeled times for the paper's
cluster, not times of the device the port runs on.

Conventions: times in seconds, sizes in bytes, rates in bytes/s or flop/s.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from repro_torch.gnn.models import GNNSpec

__all__ = ["ClusterSpec", "PAPER_CLUSTER", "ServeEstimate", "serve_request"]


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


@dataclasses.dataclass(frozen=True)
class ServeEstimate:
    """Cluster service time of ONE micro-batch at one worker."""

    service_time: float   # sample + fetch + compute (serial per worker)
    sample_time: float
    fetch_time: float
    compute_time: float
    fetch_bytes: int      # embedding-store MISS bytes, f32
    wire_bytes: int = 0   # == fetch_bytes (fp32 wire)


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
) -> ServeEstimate:
    """Price one serving micro-batch from its measured MFG + store metrics:
    sampling the `hops`-deep MFG (remote adjacency accesses cost network
    latency), fetching the cache-MISS embedding rows (`embed_dim` * 4 bytes
    each) and recomputing the last `hops` layers, forward only."""
    num_input = float(num_input)
    edges = float(edges)
    sample = (edges / cluster.sample_rate
              + float(num_remote) * cluster.remote_adj_cost
              + cluster.sample_hop_overhead * hops)
    fetch_bytes = int(num_miss) * embed_dim * 4
    wire_bytes = int(round(int(num_miss) * embed_dim * 4.0))
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

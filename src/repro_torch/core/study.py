"""The paper's experiment harness (RQ-1 .. RQ-5) + the serving study.

Twin of repro/core/study.py: the same grid, row builders, serializers and
column names, over the port's partitioners, books, cost model, trainers,
layer-wise inference and serving. Runs the full grid — graphs x
partitioners x k x GNN hyper-parameters — and emits rows that the
per-figure benchmarks aggregate. Partitions and books are cached per
(graph, partitioner, k, seed) because the GNN-parameter grid reuses them
(exactly how the paper amortises partitioning across runs).

The `*_result_row` functions are the ONE serializer per regime: the study
grid and the CLI drivers (`launch/gnn_train.py --out-json`,
`launch/gnn_serve.py --out-json`) build their JSON rows through them, so a
row means the same thing wherever it was produced. `write_rows` is the
shared file emitter.

Only the rows that run a model take a device: `minibatch_row` with
`run_device_step=True` trains on it and `serve_row` infers and serves on
it, each on a keyword-only `device` ("cuda" unless the caller asks for
the CPU; "cuda" raises when no GPU is visible). `fullbatch_row` and the
sampling-only mini-batch row are the cost model over a real partition and
run on the host. A row's `MEASURED_COLUMNS` come from a clock (or, for
`loss`, from training); every other column is computed in NumPy from the
partition, the sampled counts and the cost model, so it is the same on
every device and equals the reference's row on the same inputs.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Iterable, Optional

import numpy as np

from repro_torch.core import cost_model
from repro_torch.core.cost_model import PAPER_CLUSTER, ClusterSpec
from repro_torch.core.device import resolve_device
from repro_torch.core.edge_partition import partition_edges
from repro_torch.core.graph import Graph, paper_graph
from repro_torch.core.metrics import (
    edge_partition_metrics,
    vertex_partition_metrics,
)
from repro_torch.core.partition_book import (
    build_blockrow_book,
    build_edge_book,
    build_vertex_book,
)
from repro_torch.core.vertex_partition import partition_vertices
from repro_torch.core.wire import as_codec
from repro_torch.gnn.models import GNNSpec
from repro_torch.gnn.sampling import PAPER_FANOUTS
from repro_torch.obs import aggregate as obs_aggregate

# Paper Table 2 grid.
PAPER_GRID = {  # lint: keep — documents the paper's model-size sweep
    "hidden_dim": (16, 64, 512),
    "feature_size": (16, 64, 512),
    "num_layers": (2, 3, 4),
}

EDGE_METHODS = ("random", "dbh", "hdrf", "2ps-l", "hep10", "hep100")
VERTEX_METHODS = ("random", "ldg", "spinner", "bytegnn", "metis", "kahip")

# The columns a run reads off a clock, or (`loss`) trains to: partitioning
# seconds, the mini-batch row's six `host_phase_means` columns, serving's
# measured host compute a batch, the amortisation derived from the
# partition seconds, and the CLI rows' loss. Every other column is
# computed from bit-identical partitions, sampled counts and cost-model
# inputs, so two runs of one row agree on it exactly, on any device.
MEASURED_COLUMNS = (
    "partition_time",
    "host_sample_time", "host_fetch_time", "host_transfer_time",
    "host_compute_time", "host_step_wall", "overlap_efficiency",
    "host_mean",
    "amortize_epochs",
    "loss",
)


@dataclasses.dataclass
class PartitionRecord:
    method: str
    k: int
    assignment: np.ndarray
    partition_time: float
    metrics: object
    book: object = None


class StudyCache:
    """Memoises partitions/books across the hyper-parameter grid."""

    def __init__(self) -> None:
        self._graphs: dict = {}
        self._edge: dict = {}
        self._vertex: dict = {}
        self._blockrow: dict = {}

    def graph(self, key: str, scale: float, seed: int = 0) -> Graph:
        gk = (key, scale, seed)
        if gk not in self._graphs:
            self._graphs[gk] = paper_graph(key, scale=scale, seed=seed)
        return self._graphs[gk]

    def edge_partition(
        self, graph: Graph, method: str, k: int, seed: int = 0
    ) -> PartitionRecord:
        pk = (id(graph), method, k, seed)
        if pk not in self._edge:
            t0 = time.perf_counter()
            a = partition_edges(graph, k, method, seed=seed)
            dt = time.perf_counter() - t0
            rec = PartitionRecord(
                method=method, k=k, assignment=a, partition_time=dt,
                metrics=edge_partition_metrics(graph, a, k),
                book=build_edge_book(graph, a, k),
            )
            self._edge[pk] = rec
        return self._edge[pk]

    def blockrow_partition(self, graph: Graph, k: int) -> PartitionRecord:
        """1.5D layout record (sync_mode="ring"): the "partitioner" is the
        contiguous block split — near-zero partition time by construction,
        which is exactly what tab3's amortization question needs."""
        pk = (id(graph), "blockrow", k)
        if pk not in self._blockrow:
            # time only the partitioning decision (the contiguous split),
            # matching edge_partition: runtime books are built outside the
            # window for every method
            t0 = time.perf_counter()
            a = partition_edges(graph, k, "blockrow")
            dt = time.perf_counter() - t0
            book = build_blockrow_book(graph, k)
            self._blockrow[pk] = PartitionRecord(
                method="blockrow", k=k, assignment=a, partition_time=dt,
                metrics=edge_partition_metrics(graph, a, k),
                book=book,
            )
        return self._blockrow[pk]

    def vertex_partition(
        self, graph: Graph, method: str, k: int, seed: int = 0,
        train_mask: Optional[np.ndarray] = None,
    ) -> PartitionRecord:
        pk = (id(graph), method, k, seed)
        if pk not in self._vertex:
            t0 = time.perf_counter()
            a = partition_vertices(graph, k, method, seed=seed, train_mask=train_mask)
            dt = time.perf_counter() - t0
            rec = PartitionRecord(
                method=method, k=k, assignment=a, partition_time=dt,
                metrics=vertex_partition_metrics(graph, a, k, train_mask),
                book=build_vertex_book(graph, a, k),
            )
            self._vertex[pk] = rec
        return self._vertex[pk]


_GLOBAL_CACHE = StudyCache()


def _json_default(o):
    if hasattr(o, "item"):  # numpy scalars
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)


def _json_clean(v):
    """Strict-JSON value: non-finite floats -> null (e.g. an idle serving
    worker's NaN p99 / infinite sustainable QPS), containers recursed."""
    if isinstance(v, dict):
        return {k: _json_clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, np.ndarray)):
        return [_json_clean(x) for x in v]
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and not np.isfinite(v):
        return None
    return v


def write_rows(rows: Iterable[dict], path: str) -> None:
    """The one JSON emitter: a list of study-format rows, one strict-JSON
    file (jq/JSON.parse-safe: no bare NaN/Infinity tokens)."""
    with open(path, "w") as f:
        json.dump(_json_clean(list(rows)), f, indent=1,
                  default=_json_default)
        f.write("\n")


# ---------------------------------------------------------------------------
# DistGNN-side study rows (full-batch / edge partitioning)
# ---------------------------------------------------------------------------


def fullbatch_result_row(
    graph_key: str,
    method: str,
    k: int,
    spec: GNNSpec,
    *,
    metrics,
    partition_time: float,
    est,
    sync_mode: str = "halo",
    codec: str = "fp32",
    recovery=None,
) -> dict:
    """Serialize one DistGNN result (shared by the study grid and the CLI).

    `comm_bytes` is the logical (f32) replica-sync volume; `wire_bytes` is
    what actually crosses the network under `codec` (equal under fp32).
    `recovery` (a `cost_model.RecoveryEstimate`, optional) adds the priced
    cost of one worker-loss recovery — restore + re-partition + re-compile
    — which is how a partitioner's quality advantage gets taxed by churn."""
    wire = est.comm_bytes if getattr(est, "wire_bytes", None) is None else est.wire_bytes
    rec_cols = {}
    if recovery is not None:
        rec_cols = {
            "recovery_time": float(recovery.recovery_time),
            "recovery_restore_time": float(recovery.restore_time),
            "recovery_repartition_time": float(recovery.repartition_time),
            "recovery_recompile_time": float(recovery.recompile_time),
        }
    return {
        "graph": graph_key, "method": method, "k": k,
        "sync_mode": sync_mode, "codec": codec,
        "model": spec.model, "feature": spec.feature_dim,
        "hidden": spec.hidden_dim, "layers": spec.num_layers,
        "rf": metrics.replication_factor,
        "edge_balance": metrics.edge_balance,
        "vertex_balance": metrics.vertex_balance,
        "partition_time": partition_time,
        "epoch_time": est.epoch_time,
        "comm_bytes": float(est.comm_bytes.sum()),
        "wire_bytes": float(wire.sum()),
        "memory_total": float(est.memory.sum()),
        "memory_max": float(est.memory.max()),
        "memory_balance": float(est.memory.max() / est.memory.mean()),
        "oom": est.oom,
        **rec_cols,
    }


def fullbatch_row(
    graph_key: str,
    method: str,
    k: int,
    spec: GNNSpec,
    *,
    scale: float = 0.03,
    seed: int = 0,
    cluster: ClusterSpec = PAPER_CLUSTER,
    cache: Optional[StudyCache] = None,
    sync_mode: str = "halo",
    codec=None,
) -> dict:
    """One DistGNN study row. sync_mode="ring" prices the 1.5D regime: the
    blockrow layout replaces the edge partitioner (which is then only a
    label) and the estimate runs through the overlap-aware ring model.
    `codec` (a name or `repro_torch.core.wire.Codec`) prices the
    replica-sync traffic at its wire width; the row keeps both byte
    columns. Runs no device step: the cost model over a real partition."""
    cache = cache or _GLOBAL_CACHE
    g = cache.graph(graph_key, scale, 0)
    if sync_mode == "ring":
        rec = cache.blockrow_partition(g, k)
        method = rec.method
    else:
        rec = cache.edge_partition(g, method, k, seed)
    est = cost_model.fullbatch_epoch(rec.book, spec, cluster, codec=codec)
    return fullbatch_result_row(
        graph_key, method, k, spec, metrics=rec.metrics,
        partition_time=rec.partition_time, est=est, sync_mode=sync_mode,
        codec=as_codec(codec).name,
    )


def fullbatch_speedup(rows: Iterable[dict]) -> list[dict]:
    """Attach speedup/memory ratios vs the random baseline per config."""
    rows = list(rows)
    base = {}
    for r in rows:
        if r["method"] == "random":
            key = (r["graph"], r["k"], r["model"], r["feature"], r["hidden"], r["layers"])
            base[key] = r
    out = []
    for r in rows:
        key = (r["graph"], r["k"], r["model"], r["feature"], r["hidden"], r["layers"])
        b = base.get(key)
        if b is None:
            continue
        r = dict(r)
        r["speedup"] = b["epoch_time"] / r["epoch_time"]
        r["memory_pct_random"] = 100.0 * r["memory_total"] / b["memory_total"]
        r["amortize_epochs"] = (
            r["partition_time"] / max(b["epoch_time"] - r["epoch_time"], 1e-12)
            if r["epoch_time"] < b["epoch_time"] else float("inf")
        )
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# DistDGL-side study rows (mini-batch / vertex partitioning)
# ---------------------------------------------------------------------------


def minibatch_row(
    graph_key: str,
    method: str,
    k: int,
    spec: GNNSpec,
    *,
    scale: float = 0.03,
    seed: int = 0,
    global_batch: int = 256,
    steps: int = 4,
    cluster: ClusterSpec = PAPER_CLUSTER,
    cache: Optional[StudyCache] = None,
    train_frac: float = 0.3,
    run_device_step: bool = False,
    cache_policy: str = "none",
    cache_budget: int = 0,
    overlap: bool = False,
    prefetch_depth: int = 2,
    codec=None,
    device: str = "cuda",
) -> dict:
    """One DistDGL study row: REAL sampling on the real partition, cost-model
    cluster times. `run_device_step=True` additionally trains `steps`
    data-parallel steps on `device` (the port's `MiniBatchTrainer`; "cuda"
    raises when no GPU is visible) — then `overlap`/`prefetch_depth` select
    the pipelined execution engine (gnn/pipeline.py) and the row carries its
    measured host phase times. Without it the row samples on the host and
    `device` is not read.
    `cache_policy`/`cache_budget` configure the per-worker feature cache
    (gnn/feature_store.py); network fetch is then priced from cache misses.
    `codec` compresses miss rows + gradient all-reduce on the wire: the
    device step (if run) trains through it, and the cost model prices fetch
    and all-reduce at its wire width."""
    from repro_torch.gnn.feature_store import FeatureStore

    cache = cache or _GLOBAL_CACHE
    g = cache.graph(graph_key, scale, 0)
    rng = np.random.default_rng(1234)
    train_mask = rng.random(g.num_vertices) < train_frac
    rec = cache.vertex_partition(g, method, k, seed, train_mask)

    host_times = None
    if run_device_step:
        from repro_torch.gnn.minibatch import MiniBatchTrainer

        dev = resolve_device(device)
        feats = rng.normal(size=(g.num_vertices, spec.feature_dim)).astype(np.float32)
        labels = rng.integers(0, spec.num_classes, g.num_vertices).astype(np.int32)
        tr = MiniBatchTrainer.build(
            g, rec.assignment, k, spec, feats, labels, train_mask,
            device=dev, global_batch=global_batch, seed=seed,
            cache_policy=cache_policy, cache_budget=cache_budget,
            overlap=overlap, prefetch_depth=prefetch_depth, codec=codec,
        )
        store = tr.store
        try:
            ms = [tr.train_step() for _ in range(steps)]
        finally:
            tr.close()
        inputs = np.stack([m.input_vertices for m in ms]).mean(axis=0)
        remote = np.stack([m.remote_vertices for m in ms]).mean(axis=0)
        edges = np.stack([m.edges for m in ms]).mean(axis=0)
        hits = np.stack([m.cache_hits for m in ms]).mean(axis=0)
        misses = np.stack([m.remote_misses for m in ms]).mean(axis=0)
        host_times = host_phase_means(ms)
    else:
        # sampling only (fast path): identical metrics, no device compute
        from repro_torch.gnn.sampling import SamplePlan, sample_blocks

        store = FeatureStore.build(
            g, rec.book, policy=cache_policy, budget=cache_budget,
            feature_dim=spec.feature_dim, seed=seed, codec=codec,
        )
        fanouts = PAPER_FANOUTS[spec.num_layers]
        spw = max(global_batch // k, 1)
        plan = SamplePlan.build(spw, fanouts)
        labels = np.zeros(g.num_vertices, np.int32)
        per = [[], [], [], [], []]
        srng = np.random.default_rng(seed)
        train_ids = np.where(train_mask)[0]
        pools = [train_ids[rec.assignment[train_ids] == w] for w in range(k)]
        for _ in range(steps):
            for w in range(k):
                pool = pools[w]
                if pool.shape[0] == 0:
                    for lst in per:
                        lst.append(0)
                    continue
                s = srng.choice(pool, size=min(spw, pool.shape[0]), replace=False)
                b = sample_blocks(g, s.astype(np.int64), fanouts, plan, srng,
                                  labels, owner=rec.assignment, worker=w)
                fs = store.stats(w, b.input_ids[b.input_mask])
                per[0].append(b.num_input)
                per[1].append(b.num_remote)
                per[2].append(b.num_edges)
                per[3].append(fs.num_cache_hit)
                per[4].append(fs.num_remote_miss)
        inputs = np.array(per[0], dtype=np.float64).reshape(steps, k).mean(axis=0)
        remote = np.array(per[1], dtype=np.float64).reshape(steps, k).mean(axis=0)
        edges = np.array(per[2], dtype=np.float64).reshape(steps, k).mean(axis=0)
        hits = np.array(per[3], dtype=np.float64).reshape(steps, k).mean(axis=0)
        misses = np.array(per[4], dtype=np.float64).reshape(steps, k).mean(axis=0)

    owned = rec.book.sizes.astype(np.float64)
    est = cost_model.minibatch_step(
        inputs, remote, edges, owned, spec, cluster,
        seeds_per_worker=max(global_batch // k, 1),
        remote_miss_vertices=misses, cached_vertices=store.cache_sizes,
        codec=codec,
    )
    steps_per_epoch = max(int(train_mask.sum()) // global_batch, 1)
    return minibatch_result_row(
        graph_key, method, k, spec, metrics=rec.metrics,
        partition_time=rec.partition_time, batch=global_batch,
        inputs=inputs, remote=remote, hits=hits, misses=misses,
        est=est, steps_per_epoch=steps_per_epoch,
        cache_policy=cache_policy, cache_budget=cache_budget,
        codec=as_codec(codec).name,
        # the overlap column means "the pipelined engine actually ran" —
        # the sampling-only fast path executes nothing, so it stays serial
        overlap=overlap and run_device_step, prefetch_depth=prefetch_depth,
        host_times=host_times,
    )


# the reduction itself lives in the observability layer, shared with the
# tracer's consumers; this name stays as the study-side entry point
host_phase_means = obs_aggregate.phase_means


def minibatch_result_row(
    graph_key: str,
    method: str,
    k: int,
    spec: GNNSpec,
    *,
    metrics,
    partition_time: float,
    batch: int,
    inputs: np.ndarray,
    remote: np.ndarray,
    hits: np.ndarray,
    misses: np.ndarray,
    est,
    steps_per_epoch: int,
    cache_policy: str = "none",
    cache_budget: int = 0,
    overlap: bool = False,
    prefetch_depth: int = 0,
    host_times: Optional[dict] = None,
    codec: str = "fp32",
) -> dict:
    """Serialize one DistDGL result (shared by the study grid and the CLI).

    `step_time` models the serial phase structure, `step_time_overlap` the
    pipelined one (cost_model.overlapped_step_time); `host_times` — from
    `host_phase_means` when a device step actually ran — adds the measured
    wall times next to the modeled cluster times.
    `fetch_bytes` is the logical (f32) miss volume, `wire_bytes` the
    encoded volume under `codec` (equal under fp32)."""
    wire = est.fetch_bytes if getattr(est, "wire_bytes", None) is None else est.wire_bytes
    row = {
        "graph": graph_key, "method": method, "k": k,
        "codec": codec,
        "model": spec.model, "feature": spec.feature_dim,
        "hidden": spec.hidden_dim, "layers": spec.num_layers,
        "batch": batch,
        "edge_cut": metrics.edge_cut,
        "vertex_balance": metrics.vertex_balance,
        "train_vertex_balance": metrics.train_vertex_balance,
        "partition_time": partition_time,
        "input_vertices": float(inputs.mean()),
        "input_vertex_balance": float(inputs.max() / max(inputs.mean(), 1e-9)),
        "remote_vertices": float(remote.sum()),
        "cache_policy": cache_policy,
        "cache_budget": int(cache_budget),
        "cache_hits": float(hits.sum()),
        "remote_misses": float(misses.sum()),
        "hit_rate": float(hits.sum() / remote.sum()) if remote.sum() else 1.0,
        "fetch_bytes": float(est.fetch_bytes.sum()),
        "wire_bytes": float(np.asarray(wire).sum()),
        "step_time": est.step_time,
        "step_time_overlap": cost_model.overlapped_step_time(est),
        "epoch_time": est.step_time * steps_per_epoch,
        "sample_time": float(est.sample_time.max()),
        "fetch_time": float(est.fetch_time.max()),
        "compute_time": float(est.compute_time.max()),
        "memory_total": float(est.memory.sum()),
        "time_balance": float(
            (est.sample_time + est.fetch_time + est.compute_time).max()
            / max((est.sample_time + est.fetch_time + est.compute_time).mean(), 1e-12)
        ),
        "overlap": bool(overlap),
        # serial rows carry depth 0: the knob only means something when the
        # pipeline is on
        "prefetch_depth": int(prefetch_depth) if overlap else 0,
    }
    if host_times is not None:
        row.update(host_times)
    return row


# ---------------------------------------------------------------------------
# Serving-side study rows (layer-wise inference + micro-batched requests)
# ---------------------------------------------------------------------------


def serve_result_row(
    graph_key: str,
    method: str,
    k: int,
    spec: GNNSpec,
    report,
    *,
    qps: float,
    hops: int,
    fanout: int,
    max_batch: int,
    max_wait: float,
    cache_policy: str = "none",
    cache_budget: int = 0,
    partition_time: float = 0.0,
    partition_quality: Optional[float] = None,
    codec: str = "fp32",
) -> dict:
    """Serialize one serving run (shared by `launch/gnn_serve.py --out-json`
    and the study grid). `report` is a `repro_torch.serve.ServingReport`;
    `partition_quality` is the regime's scalar (edge-cut for vertex
    partitions, replication factor for edge partitions). `miss_bytes` is
    the logical (f32) miss volume; `wire_bytes` is the encoded volume
    measured by the embedding store under `codec`. Latencies are modeled
    on the paper's cluster; `host_mean` is the measured host compute a
    batch."""
    fetch = report.fetch
    return {
        "graph": graph_key, "method": method, "k": k,
        "codec": codec,
        "model": spec.model, "feature": spec.feature_dim,
        "hidden": spec.hidden_dim, "layers": spec.num_layers,
        "regime": "serve",
        "qps_offered": float(qps),
        "hops": int(hops), "fanout": int(fanout),
        "max_batch": int(max_batch), "max_wait": float(max_wait),
        "cache_policy": cache_policy, "cache_budget": int(cache_budget),
        "partition_time": partition_time,
        "partition_quality": partition_quality,
        "requests": report.served(),
        "batches": int(report.batch_size.shape[0]),
        "latency_p50": report.p50(),
        "latency_p99": report.p99(),
        "latency_mean": float(report.latency.mean()),
        "service_mean": float(report.service_time.mean()),
        "host_mean": float(report.host_time.mean()),
        "qps_sustainable": report.sustainable_qps(),
        "qps_per_worker": [report.sustainable_qps(w) for w in range(report.k)],
        "p99_per_worker": [r["p99"] for r in report.worker_rows()],
        "remote_vertices": fetch.num_remote,
        "cache_hits": fetch.num_cache_hit,
        "remote_misses": fetch.num_remote_miss,
        "hit_rate": fetch.hit_rate,
        "miss_bytes": fetch.miss_bytes,
        "wire_bytes": fetch.wire_bytes,
        # queue-wait vs service-time attribution from the request spans
        # (queue span = enqueue→dispatch, service span = dispatch→done):
        # lets a figure attribute a p99 to queueing vs compute
        **obs_aggregate.request_breakdown(
            report.latency, getattr(report, "queue_wait", None)),
        **_serve_fault_cols(report),
    }


def _serve_fault_cols(report) -> dict:
    """Degraded-window columns of a faulted serving run (worker-death)."""
    if getattr(report, "fault_time", None) is None:
        return {}
    ts = report.transition_stats()
    return {
        "fault_time": ts["fault_time"],
        "dead_worker": int(report.dead_worker),
        "rerouted": ts["rerouted"],
        "transition_window": ts["window"],
        "transition_requests": ts["requests"],
        "transition_p50": ts["p50"],
        "transition_p99": ts["p99"],
    }


def serve_row(
    graph_key: str,
    method: str,
    k: int,
    spec: GNNSpec,
    *,
    scale: float = 0.03,
    seed: int = 0,
    qps: float = 200.0,
    n_requests: int = 240,
    hops: int = 1,
    fanout: int = 10,
    max_batch: int = 32,
    max_wait: float = 5e-4,
    cache_policy: str = "none",
    cache_budget: int = 0,
    cluster: ClusterSpec = PAPER_CLUSTER,
    cache: Optional[StudyCache] = None,
    codec=None,
    fault_plan=None,
    detect_delay: float = 0.0,
    device: str = "cuda",
) -> dict:
    """One serving study row: REAL layer-wise inference + request simulation
    on the real partition, on `device` ("cuda" raises when no GPU is
    visible), cost-model cluster latencies. `codec` installs a wire codec
    on the embedding store: miss rows are decoded from their encoded form
    (lossy codecs perturb served embeddings) and the service time is
    priced from encoded bytes.

    `fault_plan` (a `repro_torch.fault.FaultPlan` with a worker-death
    event) kills one worker mid-trace; the failover map is derived here
    (replica-aware for edge partitions) and the row gains the
    degraded-window columns.

    `method` may be a vertex partitioner (the embedding store shards by it
    directly) or an edge partitioner (the store shards by the edge book's
    masters). Layer-wise embeddings are memoised per (graph, spec, seed,
    device) — the method x policy x budget x qps grid reuses them, exactly
    like partitions are reused across the training grid; the device is in
    the key, so a CPU row and a card row on one cache never share
    parameters or embeddings.
    """
    from repro_torch.gnn.inference import (
        LayerwiseInference,
        edge_assignment_from_vertex,
    )
    from repro_torch.gnn.models import init_params
    from repro_torch.serve.engine import build_serving, run_serving_sim

    dev = resolve_device(device)
    cache = cache or _GLOBAL_CACHE
    g = cache.graph(graph_key, scale, 0)
    # names shared by both regimes (e.g. "random") resolve as VERTEX
    # partitioners — the embedding store shards by vertex ownership
    if method in VERTEX_METHODS or method not in EDGE_METHODS:
        rec = cache.vertex_partition(g, method, k, seed)
        owner = rec.assignment
        edge_assignment = edge_assignment_from_vertex(g, owner)
        quality = rec.metrics.edge_cut
        edge_book = None  # vertex partitions hold no replicas
    else:
        rec = cache.edge_partition(g, method, k, seed)
        edge_assignment = rec.assignment
        owner = rec.book.master_assignment()
        quality = rec.metrics.replication_factor
        edge_book = rec.book

    memo = getattr(cache, "_serve_embeddings", None)
    if memo is None:
        memo = cache._serve_embeddings = {}
    # layer-wise inference == the full-batch forward for ANY partition
    # (tested per backend), so the embeddings are partition-invariant:
    # one pass per (graph, spec, seed, device) serves every (method, k)
    # cell; the parameters live on `dev`, so the device is in the key
    key = (id(g), spec, seed, dev)
    if key not in memo:
        rng = np.random.default_rng(seed)
        feats = rng.normal(size=(g.num_vertices, spec.feature_dim))
        params = init_params(spec, seed=seed, device=dev)
        eng = LayerwiseInference.build(
            g, edge_assignment, k, spec, params, feats.astype(np.float32),
            device=dev)
        memo[key] = (params, eng.run())
    params, embeddings = memo[key]

    vbook = build_vertex_book(g, owner, k)
    engines, batchers, _ = build_serving(
        g, vbook, spec, params, embeddings, device=dev,
        hops=hops, fanout=fanout, max_batch=max_batch, max_wait=max_wait,
        cache_policy=cache_policy, cache_budget=cache_budget, seed=seed,
        codec=codec,
    )
    rng = np.random.default_rng(seed + 99)
    request_ids = rng.integers(0, g.num_vertices, n_requests)
    arrivals = np.sort(rng.uniform(0.0, n_requests / qps, n_requests))
    failover = None
    if fault_plan is not None and fault_plan.events_of("worker-death"):
        from repro_torch.fault.recovery import failover_assignment

        ev = fault_plan.events_of("worker-death")[0]
        dead = fault_plan.resolve_worker(ev, k)
        failover = failover_assignment(owner, dead, k, book=edge_book)
    report = run_serving_sim(engines, batchers, owner, request_ids, arrivals,
                             cluster=cluster, fault_plan=fault_plan,
                             failover_owner=failover,
                             detect_delay=detect_delay)
    return serve_result_row(
        graph_key, method, k, spec, report,
        qps=qps, hops=hops, fanout=fanout, max_batch=max_batch,
        max_wait=max_wait, cache_policy=cache_policy,
        cache_budget=cache_budget, partition_time=rec.partition_time,
        partition_quality=quality, codec=as_codec(codec).name,
    )


def minibatch_speedup(rows: Iterable[dict]) -> list[dict]:
    rows = list(rows)
    base = {}
    for r in rows:
        if r["method"] == "random":
            key = (r["graph"], r["k"], r["model"], r["feature"], r["hidden"],
                   r["layers"], r["batch"])
            base[key] = r
    out = []
    for r in rows:
        key = (r["graph"], r["k"], r["model"], r["feature"], r["hidden"],
               r["layers"], r["batch"])
        b = base.get(key)
        if b is None:
            continue
        r = dict(r)
        r["speedup"] = b["epoch_time"] / r["epoch_time"]
        r["net_pct_random"] = 100.0 * r["fetch_bytes"] / max(b["fetch_bytes"], 1e-9)
        r["remote_pct_random"] = 100.0 * r["remote_vertices"] / max(b["remote_vertices"], 1e-9)
        r["memory_pct_random"] = 100.0 * r["memory_total"] / b["memory_total"]
        r["amortize_epochs"] = (
            r["partition_time"] / max(b["epoch_time"] - r["epoch_time"], 1e-12)
            if r["epoch_time"] < b["epoch_time"] else float("inf")
        )
        out.append(r)
    return out

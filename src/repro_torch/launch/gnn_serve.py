"""The serving CLI: partition, layer-wise-infer, then serve traffic.

Twin of repro/launch/gnn_serve.py. Partition a graph (edge OR vertex
partitioner — the embedding store shards by masters resp. owners), run the
layer-wise inference engine to materialise the per-layer embedding stores,
then drive a Poisson request trace through the micro-batched online path
and report per-worker p50/p99 latency and sustainable QPS, modeled on the
paper's cluster, beside the measured host compute per batch.

Runs on the card unless `--device cpu` is given; with `--device cuda` and
no GPU it raises. Features, request ids and arrivals are drawn from
`np.random.default_rng(seed)` in the reference's order, so both CLIs serve
the same requests. `--codec` sets the wire codec (core/wire.py) of the
embedding store: remote-miss rows are shipped encoded and decoded at the
reader, and the modeled service time is priced from the encoded bytes.
`--trace PATH` records the run's timeline to PATH (Chrome trace-event
JSON, schema gnn-trace/v1: inference layers and the real gather/compute
spans on the host process, the request lifecycle on the simulated clock)
and the reconciliation report to PATH.report.json. Study rows
(`--out-json`, ROADMAP queue 1, item 2) are not yet ported and are
refused.

`--inject-fault worker-death@t:T,worker:W` kills serving worker W at
virtual time T: its unanswered requests fail over to the survivors after
`--detect-delay` seconds, by a map that is replica-aware under an edge
partitioner (each vertex to the first survivor holding a mirror of it) and
a deterministic spread under a vertex one; every request is still
answered, and the worker-death summary prints the rerouted count and the
transition window's latency. An unknown spec exits 1 naming the valid
kinds.

  PYTHONPATH=src python -m repro_torch.launch.gnn_serve --graph OR \
      --scale 0.05 --partitioner hep100 --k 4 --model sage --qps 100 --smoke
  PYTHONPATH=src python -m repro_torch.launch.gnn_serve --graph OR \
      --scale 0.05 --k 4 --smoke --inject-fault worker-death@t:1.0,worker:1
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cost_model import PAPER_CLUSTER
from repro_torch.core.device import DEVICES, resolve_device
from repro_torch.core.edge_partition import EDGE_PARTITIONERS, partition_edges
from repro_torch.core.graph import Graph, paper_graph
from repro_torch.core.metrics import edge_partition_metrics, vertex_partition_metrics
from repro_torch.core.partition_book import build_vertex_book
from repro_torch.core.vertex_partition import VERTEX_PARTITIONERS, partition_vertices
from repro_torch.core.wire import CODECS
from repro_torch.fault import FaultPlan, FaultSpecError
from repro_torch.fault.recovery import failover_assignment
from repro_torch.gnn.feature_store import CACHE_POLICIES, RowStore
from repro_torch.gnn.inference import LayerwiseInference, edge_assignment_from_vertex
from repro_torch.gnn.models import GNNSpec, init_params
from repro_torch.launch.gnn_train import (
    NOT_PORTED,
    refuse_not_ported,
    write_traced_run,
)
from repro_torch.obs import Tracer, get_tracer, install, reconcile
from repro_torch.serve.engine import ServingReport, build_serving, run_serving_sim


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.gnn_serve",
        description="Partition a graph, run layer-wise GNN inference into "
                    "embedding stores, then serve a simulated request trace.")
    ap.add_argument("--device", default="cuda", choices=list(DEVICES),
                    help="where the model runs; cuda raises if no GPU is "
                         "visible")
    ap.add_argument("--graph", default="OR", choices=["HO", "DI", "EN", "EU", "OR"])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--partitioner", default="hep100",
                    help="edge partitioner (store shards by masters) or "
                         "vertex partitioner (store shards by owners)")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--model", default="sage", choices=["sage", "gcn", "gat"])
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--agg-backend", default="scatter",
                    choices=["scatter", "tiled", "pallas"],
                    help="scatter: index_add_/scatter_reduce_; tiled: the "
                         "CUDA segment-reduce kernel on the card (its plain "
                         "version on the CPU); pallas: always the kernel")
    ap.add_argument("--qps", type=float, default=100.0,
                    help="offered load (Poisson arrivals, whole cluster)")
    ap.add_argument("--requests", type=int, default=1000,
                    help="length of the simulated request trace")
    ap.add_argument("--hops", type=int, default=1,
                    help="final layers recomputed per request (1..layers-1); "
                         "the rest is read from the embedding store")
    ap.add_argument("--fanout", type=int, default=10)
    ap.add_argument("--batch", type=int, default=32,
                    help="micro-batch size cap")
    ap.add_argument("--max-wait", type=float, default=5e-4,
                    help="seconds a request may wait for its micro-batch")
    ap.add_argument("--codec", default="fp32", choices=list(CODECS),
                    help="wire codec (core/wire.py) of the embedding store: "
                         "remote-miss rows are shipped encoded and decoded "
                         "at the reader; service time is priced from the "
                         "encoded bytes")
    ap.add_argument("--cache-policy", default="none",
                    choices=list(CACHE_POLICIES))
    ap.add_argument("--cache-budget", type=int, default=0,
                    help="cached remote embedding rows per worker")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="record the span/counter timeline to PATH (Chrome "
                         "trace-event JSON, schema gnn-trace/v1: inference "
                         "layers + real gather/compute spans on the host "
                         "process, the request lifecycle on the simulated "
                         "clock) and write the reconciliation report to "
                         "PATH.report.json")
    ap.add_argument("--inject-fault", action="append", default=[],
                    metavar="SPEC",
                    help="deterministic fault injection (repeatable): "
                         "worker-death@t:0.5,worker:1 kills a serving "
                         "worker at virtual time t; its requests fail over "
                         "to surviving workers (replica-aware "
                         "master_assignment re-derivation) and EVERY "
                         "request is still answered")
    ap.add_argument("--detect-delay", type=float, default=0.0,
                    help="seconds before a death is detected (rerouted "
                         "requests become visible to survivors after it)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-fast: trim the request trace")
    ap.add_argument("--seed", type=int, default=0)
    return ap


@dataclasses.dataclass
class ServeRun:
    """What one `run` produced, for callers that check it."""

    graph: Graph
    spec: GNNSpec
    embeddings: list             # per-layer [V, d_l], input side first
    inference: LayerwiseInference
    report: ServingReport
    store: RowStore              # the embedding store the requests read
    fault_plan: Optional[FaultPlan] = None  # the --inject-fault plan, if any
    tracer: Optional[Tracer] = None         # the run's tracer under --trace
    trace_report: Optional[object] = None   # its ReconcileReport


def run(argv: Optional[list] = None) -> ServeRun:
    """Parse `argv` (default: sys.argv[1:]) and serve; prints a report."""
    argv = sys.argv[1:] if argv is None else argv
    refuse_not_ported(argv, NOT_PORTED)
    args = parser().parse_args(argv)
    if args.smoke:
        args.requests = min(args.requests, 200)
    plan = None
    if args.inject_fault:
        try:
            plan = FaultPlan.parse(args.inject_fault, seed=args.seed)
        except FaultSpecError as e:
            print(f"[serve] bad --inject-fault: {e}")
            sys.exit(1)
        print(f"[serve] fault plan: "
              f"{'; '.join(ev.describe() for ev in plan.events)}")
    device = resolve_device(args.device)
    # the tracer is the process's for the run, and only for it
    prev = get_tracer()
    tracer = install(Tracer()) if args.trace else None
    try:
        out = _serve(args, device, plan)
        if tracer is not None:
            checks = reconcile.reconcile_serving(out.report, out.store,
                                                 tracer=tracer)
            if plan is not None:
                checks += reconcile.reconcile_recovery(plan, tracer=tracer)
            out.tracer = tracer
            out.trace_report = write_traced_run("serve", args.trace, tracer,
                                                checks)
        return out
    finally:
        install(prev)


def _serve(args, device, plan) -> ServeRun:
    g = paper_graph(args.graph, scale=args.scale, seed=0)
    print(f"[serve] graph {args.graph}: {g.num_vertices} vertices, "
          f"{g.num_edges} edges")
    spec = GNNSpec(model=args.model, feature_dim=args.features,
                   hidden_dim=args.hidden, num_classes=args.classes,
                   num_layers=args.layers, agg_backend=args.agg_backend)
    rng = np.random.default_rng(args.seed)
    feats = rng.normal(size=(g.num_vertices, args.features)).astype(np.float32)
    params = init_params(spec, seed=args.seed, device=device)

    # ---------------------------------------------------------- partition
    t0 = time.perf_counter()
    if args.partitioner in EDGE_PARTITIONERS:
        edge_assignment = partition_edges(g, args.k, args.partitioner,
                                          seed=args.seed)
        pt = time.perf_counter() - t0
        m = edge_partition_metrics(g, edge_assignment, args.k)
        print(f"[serve] edge-partitioned in {pt:.2f}s: "
              f"rf={m.replication_factor:.2f} edge_bal={m.edge_balance:.2f}")
        owner = None  # derived from masters below
    elif args.partitioner in VERTEX_PARTITIONERS:
        owner = partition_vertices(g, args.k, args.partitioner, seed=args.seed)
        pt = time.perf_counter() - t0
        m = vertex_partition_metrics(g, owner, args.k)
        print(f"[serve] vertex-partitioned in {pt:.2f}s: "
              f"edge_cut={m.edge_cut:.3f} vertex_bal={m.vertex_balance:.2f}")
        edge_assignment = edge_assignment_from_vertex(g, owner)
    else:
        raise ValueError(
            f"unknown partitioner {args.partitioner!r}; edge options "
            f"{sorted(EDGE_PARTITIONERS)}, vertex options "
            f"{sorted(VERTEX_PARTITIONERS)}")

    # ------------------------------------------- layer-wise embedding pass
    engine = LayerwiseInference.build(
        g, edge_assignment, args.k, spec, params, feats, device=device)
    embeddings = engine.run()
    if owner is None:
        owner = engine.book.master_assignment()
    vbook = build_vertex_book(g, owner, args.k)
    dims = "/".join(str(e.shape[1]) for e in embeddings)
    layer_ms = ", ".join(f"{t * 1e3:.1f}" for t in engine.layer_times)
    print(f"[serve] layer-wise inference on {device}: {len(embeddings)} "
          f"layers (dims {dims}) in {sum(engine.layer_times):.3f}s "
          f"(per layer ms: {layer_ms}), "
          f"halo traffic {engine.sync_bytes()/2**20:.1f} MiB/pass")

    # ------------------------------------------------------- online serving
    engines, batchers, store = build_serving(
        g, vbook, spec, params, embeddings, device=device,
        hops=args.hops, fanout=args.fanout, max_batch=args.batch,
        max_wait=args.max_wait, cache_policy=args.cache_policy,
        cache_budget=args.cache_budget, seed=args.seed, codec=args.codec,
    )
    if args.cache_budget:
        print(f"[serve] embedding cache: policy={args.cache_policy} "
              f"budget={args.cache_budget}/worker "
              f"(filled {store.cache_sizes.tolist()})")
    request_ids = rng.integers(0, g.num_vertices, args.requests)
    arrivals = np.sort(rng.uniform(0.0, args.requests / args.qps,
                                   args.requests))
    failover = None
    if plan is not None and plan.events_of("worker-death"):
        ev = plan.events_of("worker-death")[0]
        dead = plan.resolve_worker(ev, args.k)
        # replica-aware only for edge partitions: mirrors already hold the
        # dead master's vertices; vertex partitions spread deterministically
        book = engine.book if args.partitioner in EDGE_PARTITIONERS else None
        failover = failover_assignment(owner, dead, args.k, book=book)
        moved = int((np.asarray(owner) == dead).sum())
        print(f"[serve] failover map: worker {dead} dies, {moved} vertices "
              f"re-mastered "
              f"({'replica-aware' if book is not None else 'spread'})")
    report = run_serving_sim(engines, batchers, owner, request_ids, arrivals,
                             fault_plan=plan, failover_owner=failover,
                             detect_delay=args.detect_delay)

    for row in report.worker_rows():
        print(f"[serve] worker {row['worker']}: served {row['served']:5d}  "
              f"modeled p50 {row['p50']*1e3:7.2f} ms  "
              f"p99 {row['p99']*1e3:7.2f} ms  "
              f"sustainable {row['qps_sustainable']:8.0f} qps")
    print(f"[serve] cluster (modeled on {PAPER_CLUSTER.name}): offered "
          f"{args.qps:.0f} qps, served {report.served()} requests in "
          f"{report.duration:.2f}s  p50 {report.p50()*1e3:.2f} ms  "
          f"p99 {report.p99()*1e3:.2f} ms  "
          f"sustainable {report.sustainable_qps():.0f} qps/cluster")
    print(f"[serve] store traffic: hit_rate {report.fetch.hit_rate:.2f}  "
          f"miss {report.fetch.miss_bytes/2**20:.2f} MiB  "
          f"wire {report.fetch.wire_bytes/2**20:.2f} MiB ({args.codec})  "
          f"host compute p50 {np.percentile(report.host_time, 50)*1e3:.2f} "
          f"ms/batch on {device}")
    if report.fault_time is not None:
        ts = report.transition_stats()
        answered = report.served() == args.requests
        print(f"[serve] worker-death: worker {report.dead_worker} died at "
              f"t={ts['fault_time']:.3f}s, {ts['rerouted']} requests "
              f"rerouted, transition window {ts['window']*1e3:.1f} ms "
              f"({ts['requests']} requests, modeled p50 "
              f"{ts['p50']*1e3:.2f} ms, p99 {ts['p99']*1e3:.2f} ms)")
        print(f"[serve] every request answered: {answered} "
              f"({report.served()}/{args.requests})")
        if not answered:
            sys.exit(1)
    return ServeRun(graph=g, spec=spec, embeddings=embeddings,
                    inference=engine, report=report, store=store,
                    fault_plan=plan)


def main(argv: Optional[list] = None) -> None:
    with torch.inference_mode():
        run(argv)


if __name__ == "__main__":
    main()

"""gnn_trace: record a traced run per regime and reconcile it against the
analytic cost model (twin of repro/launch/gnn_trace.py).

Runs small representative programs with the tracer installed:

  fullbatch-halo / fullbatch-ring : traced training steps per sync
      strategy; the strategies report every collective (kind + bytes) of
      each forward pass, reconciled against `collective_budget` and
      `sync_wire_bytes_per_round`, and the per-epoch wire bytes against
      `FullBatchTrainer.wire_bytes_per_epoch`.
  minibatch : serial mini-batch steps; feature-fetch wire/miss bytes are
      measured at the gather encode site and reconciled against
      `Codec.wire_bytes`, phases against the step wall, the gradient
      all-reduce against `cost_model.minibatch_step`'s parameter count.
  serve : layer-wise inference + the micro-batched serving sim; embedding
      wire bytes and the request-latency closure are reconciled.

Outputs a merged Chrome trace-event timeline (schema gnn-trace/v1, loadable
in https://ui.perfetto.dev or chrome://tracing) which is round-tripped
through the exporter's own loader, plus a JSON reconciliation report
(schema "gnn-trace-report/v2"). The programs run on the card unless
`--device cpu` is given; with `--device cuda` and no GPU it raises. Run
from the repo root:

    PYTHONPATH=src python -m repro_torch.launch.gnn_trace --smoke \\
        --out-trace trace.json --out-json gnn_trace_report.json
    PYTHONPATH=src python -m repro_torch.launch.gnn_trace --smoke \\
        --device cpu

Exit code 0 = every check holds; 1 = at least one reconciliation
violation. `--inject-violation` adds one stray byte to the measured
mini-batch fetch counter — a deliberate byte mismatch proving the gate
exits non-zero (fp32 checks are EXACT: one byte is enough).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.core.device import DEVICES, resolve_device


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.gnn_trace",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("--device", default="cuda", choices=list(DEVICES),
                   help="where the programs run; cuda raises if no GPU is "
                        "visible")
    p.add_argument("--smoke", action="store_true",
                   help="run the CI-sized programs (default sizes are a "
                        "seconds-fast cross-section)")
    p.add_argument("--codec", default="fp32",
                   help="wire codec for every program (fp32 reconciles "
                        "exactly; int8 within its codec-width ratio)")
    p.add_argument("--out-trace", default="trace.json", metavar="PATH",
                   help="write the merged Chrome trace-event JSON here")
    p.add_argument("--out-json", default=None, metavar="PATH",
                   help="write the reconciliation report here "
                        "('-' for stdout)")
    p.add_argument("--inject-violation", action="store_true",
                   help="corrupt the measured mini-batch fetch counter by "
                        "one byte — proves the gate exits 1")
    p.add_argument("--scale", type=float, default=None,
                   help="graph scale (default 0.01; --smoke 0.02)")
    p.add_argument("--k", type=int, default=None,
                   help="partitions/devices (default 2; --smoke 4)")
    p.add_argument("--steps", type=int, default=None,
                   help="mini-batch steps resp. full-batch epochs "
                        "(default 2; --smoke 3)")
    p.add_argument("--requests", type=int, default=None,
                   help="serving request-trace length "
                        "(default 60; --smoke 160)")
    p.add_argument("--seed", type=int, default=0)
    return p


def _spec(feature: int = 32, hidden: int = 32):
    from repro_torch.gnn.models import GNNSpec

    return GNNSpec(model="sage", feature_dim=feature, hidden_dim=hidden,
                   num_classes=8, num_layers=2)


def _node_data(g, spec, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(g.num_vertices, spec.feature_dim)).astype(
        np.float32)
    labels = rng.integers(0, spec.num_classes, g.num_vertices).astype(
        np.int32)
    train = rng.random(g.num_vertices) < 0.3
    return feats, labels, train


def _run_fullbatch(g, spec, args, sync_mode: str, device):
    """One traced full-batch program; returns (tracer, checks)."""
    from repro_torch.core.edge_partition import partition_edges
    from repro_torch.gnn.fullbatch import FullBatchTrainer
    from repro_torch.obs import Tracer, install, reconcile, uninstall

    feats, labels, train = _node_data(g, spec, args.seed)
    part = "blockrow" if sync_mode == "ring" else "hep100"
    assignment = partition_edges(g, args.k, part, seed=args.seed)
    program = f"fullbatch-{sync_mode}"
    tracer = install(Tracer())
    try:
        tr = FullBatchTrainer.build(
            g, assignment, args.k, spec, feats, labels, train,
            sync_mode=sync_mode, seed=args.seed, codec=args.codec,
            device=device)
        for _ in range(args.steps):
            tr.train_step()
        checks = reconcile.reconcile_fullbatch(tr, tracer=tracer,
                                               program=program)
    finally:
        uninstall()
    return tracer, checks


def _run_minibatch(g, spec, args, device):
    from repro_torch.core.vertex_partition import partition_vertices
    from repro_torch.gnn.minibatch import MiniBatchTrainer
    from repro_torch.obs import Tracer, install, reconcile, uninstall

    feats, labels, train = _node_data(g, spec, args.seed)
    owner = partition_vertices(g, args.k, "metis", seed=args.seed,
                               train_mask=train)
    tracer = install(Tracer())
    try:
        tr = MiniBatchTrainer.build(
            g, owner, args.k, spec, feats, labels, train, device=device,
            global_batch=64, seed=args.seed, codec=args.codec)
        sms = [tr.train_step() for _ in range(args.steps)]
        tr.close()
        if args.inject_violation:
            # the seeded red path: one stray byte through the REAL
            # measured counter — the fp32 checks are exact, so this must
            # surface as an error-level finding
            tracer.add("fetch.wire_bytes", 1)
        checks = reconcile.reconcile_minibatch(tr, sms, tracer=tracer,
                                               program="minibatch")
    finally:
        uninstall()
    return tracer, checks


def _run_serving(g, spec, args, device):
    import numpy as np

    from repro_torch.core.edge_partition import partition_edges
    from repro_torch.core.partition_book import build_vertex_book
    from repro_torch.gnn.inference import LayerwiseInference
    from repro_torch.gnn.models import init_params
    from repro_torch.obs import Tracer, install, reconcile, uninstall
    from repro_torch.serve.engine import build_serving, run_serving_sim

    feats, _, _ = _node_data(g, spec, args.seed)
    params = init_params(spec, seed=args.seed, device=device)
    assignment = partition_edges(g, args.k, "hep100", seed=args.seed)
    tracer = install(Tracer())
    try:
        eng = LayerwiseInference.build(g, assignment, args.k, spec, params,
                                       feats, device=device)
        embeddings = eng.run()
        owner = eng.book.master_assignment()
        vbook = build_vertex_book(g, owner, args.k)
        engines, batchers, store = build_serving(
            g, vbook, spec, params, embeddings, device=device, hops=1,
            fanout=8, max_batch=16, max_wait=5e-4, seed=args.seed,
            codec=args.codec)
        rng = np.random.default_rng(args.seed)
        request_ids = rng.integers(0, g.num_vertices, args.requests)
        arrivals = np.sort(rng.uniform(0.0, args.requests / 200.0,
                                       args.requests))
        report = run_serving_sim(engines, batchers, owner, request_ids,
                                 arrivals)
        checks = reconcile.reconcile_serving(report, store, tracer=tracer,
                                             program="serve")
    finally:
        uninstall()
    return tracer, checks


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.scale is None:
        args.scale = 0.02 if args.smoke else 0.01
    if args.k is None:
        args.k = 4 if args.smoke else 2
    if args.steps is None:
        args.steps = 3 if args.smoke else 2
    if args.requests is None:
        args.requests = 160 if args.smoke else 60

    from repro_torch.core.graph import paper_graph
    from repro_torch.obs import load_trace, reconcile, write_trace

    device = resolve_device(args.device)
    t_start = time.perf_counter()
    g = paper_graph("OR", scale=args.scale, seed=0)
    spec = _spec()
    print(f"[trace] graph OR x{args.scale}: {g.num_vertices} vertices, "
          f"{g.num_edges} edges; k={args.k}, codec={args.codec}, "
          f"device={device}")

    tracers, checks = [], []
    for sync_mode in ("halo", "ring"):
        tr, cs = _run_fullbatch(g, spec, args, sync_mode, device)
        tracers.append(tr)
        checks.extend(cs)
        print(f"[trace] fullbatch-{sync_mode}: {len(tr)} events, "
              f"{len(cs)} checks")
    tr, cs = _run_minibatch(g, spec, args, device)
    tracers.append(tr)
    checks.extend(cs)
    print(f"[trace] minibatch: {len(tr)} events, {len(cs)} checks")
    tr, cs = _run_serving(g, spec, args, device)
    tracers.append(tr)
    checks.extend(cs)
    print(f"[trace] serve: {len(tr)} events, {len(cs)} checks")

    payload = write_trace(args.out_trace, tracers)
    # the exporter's own loader re-parses and validates the file (schema,
    # B/E pairing, per-track monotonic timestamps) — the round-trip gate
    load_trace(args.out_trace)
    print(f"[trace] timeline -> {args.out_trace} "
          f"({len(payload['traceEvents'])} events, round-trip ok)")

    report = reconcile.build_report(
        checks, elapsed_s=time.perf_counter() - t_start)
    out = json.dumps(report.to_dict(), indent=2)
    if args.out_json == "-":
        print(out)
    elif args.out_json:
        with open(args.out_json, "w") as fh:
            fh.write(out + "\n")

    c = report.counts
    print(f"gnn_trace: {len(report.programs)} programs, "
          f"{len(report.checks)} checks in {report.elapsed_s:.1f}s — "
          f"{c.get('ok', 0)} ok, {c.get('warn', 0)} warn, "
          f"{c.get('error', 0)} error(s)")
    for ch in report.checks:
        if ch.level != "ok":
            print(f"  [{ch.level}] {ch.quantity} :: {ch.program}: "
                  f"{ch.message}")
    return report.exit_code


if __name__ == "__main__":
    sys.exit(main())

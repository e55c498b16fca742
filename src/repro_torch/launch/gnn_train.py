"""The training CLI: partition a graph, train a GNN over the partitions.

Twin of repro/launch/gnn_train.py for its full-batch regime (DistGNN-style:
edge partitioning, replica sync over the stacked partitions, the
reference's Adam). It prints what the reference prints: the graph, the
partitioning time with its replication factor and balances, the
paper-cluster epoch estimate (`cost_model.fullbatch_epoch`, modeled, not a
device time), and per epoch the loss and the step's seconds on the device.

Runs on the card unless `--device cpu` is given; with `--device cuda` and
no GPU it raises. Features, labels and the training mask are drawn from
`np.random.default_rng(seed)` in the reference's order, so both CLIs train
on the same data from the same weights. `--regime minibatch` is not yet
ported.

  PYTHONPATH=src python -m repro_torch.launch.gnn_train --graph OR \\
      --scale 0.05 --partitioner hep100 --k 4 --model sage --epochs 5
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.cost_model import FullBatchEstimate, fullbatch_epoch
from repro_torch.core.device import DEVICES, resolve_device
from repro_torch.core.edge_partition import EDGE_PARTITIONERS, partition_edges
from repro_torch.core.graph import Graph, paper_graph
from repro_torch.core.metrics import edge_partition_metrics
from repro_torch.gnn.fullbatch import FullBatchTrainer
from repro_torch.gnn.models import GNNSpec
from repro_torch.gnn.sync import SYNC_MODES

# The caching allocator's setting for training on the card. The tiled
# layout's temporaries (tens of GiB, a different size at each layer)
# fragment fixed segments: GAT at OR 1.0, widths 512, which peaks at 53 GiB
# of the 80 GB card, ran out of memory on them with 28 GiB reserved but
# free. The allocator reads it once, when CUDA starts, so `main` sets it for
# the process; a library caller of `run` chooses its own.
TRAIN_ALLOC_CONF = "expandable_segments:True"


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.gnn_train",
        description="Partition a graph and train a GNN over the partitions "
                    "(full batch, replica sync).")
    ap.add_argument("--device", default="cuda", choices=list(DEVICES),
                    help="where the model trains; cuda raises if no GPU is "
                         "visible")
    ap.add_argument("--graph", default="OR", choices=["HO", "DI", "EN", "EU", "OR"])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--partitioner", default="hep100",
                    help="edge partitioner (full batch)")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--model", default="sage", choices=["sage", "gcn", "gat"])
    ap.add_argument("--regime", default="fullbatch",
                    choices=["fullbatch", "minibatch"],
                    help="fullbatch: DistGNN-style; minibatch (DistDGL-"
                         "style) is not yet ported")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--sync-mode", default="halo", choices=list(SYNC_MODES),
                    help="halo: static-routed replica exchange; local: no "
                         "exchange (the k=1 oracle; at k > 1 the partial "
                         "aggregates stay partial)")
    ap.add_argument("--agg-backend", default="scatter",
                    choices=["scatter", "tiled", "pallas"],
                    help="scatter: index_add_/scatter_reduce_; tiled: the "
                         "CUDA segment-reduce kernel on the card (its plain "
                         "version on the CPU); pallas: always the kernel")
    ap.add_argument("--lr", type=float, default=1e-2,
                    help="Adam step size; the default is the reference "
                         "trainer's (its CLI has no flag). At widths 512 "
                         "it diverges; 1e-3, the default of Adam's paper "
                         "(Kingma & Ba, ICLR 2015, Algorithm 1), does not")
    ap.add_argument("--seed", type=int, default=0)
    return ap


@dataclasses.dataclass
class TrainRun:
    """What one `run` produced, for callers that check it."""

    graph: Graph
    spec: GNNSpec
    assignment: np.ndarray       # the edge partition
    trainer: FullBatchTrainer
    estimate: FullBatchEstimate  # modeled on the paper's cluster
    losses: list                 # per epoch, before its update
    step_seconds: list           # host clock around each step, synced
    peak_memory: Optional[int]   # bytes, torch.cuda.max_memory_allocated
                                 # over the run; None on the CPU


def run(argv: Optional[list] = None) -> TrainRun:
    """Parse `argv` (default: sys.argv[1:]) and train; prints a report."""
    args = parser().parse_args(argv)
    if args.regime == "minibatch":
        raise NotImplementedError(
            "--regime minibatch (DistDGL-style) is not yet ported; use "
            "--regime fullbatch")
    if args.partitioner not in EDGE_PARTITIONERS:
        raise ValueError(
            f"full batch (DistGNN) uses edge partitioners: "
            f"{sorted(EDGE_PARTITIONERS)}; got {args.partitioner!r}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    g = paper_graph(args.graph, scale=args.scale, seed=0)
    print(f"[gnn] graph {args.graph}: {g.num_vertices} vertices, "
          f"{g.num_edges} edges")
    rng = np.random.default_rng(args.seed)
    feats = rng.normal(size=(g.num_vertices, args.features)).astype(np.float32)
    labels = rng.integers(0, args.classes, g.num_vertices).astype(np.int32)
    train_mask = rng.random(g.num_vertices) < 0.3
    spec = GNNSpec(model=args.model, feature_dim=args.features,
                   hidden_dim=args.hidden, num_classes=args.classes,
                   num_layers=args.layers, agg_backend=args.agg_backend)

    t0 = time.perf_counter()
    assignment = partition_edges(g, args.k, args.partitioner, seed=args.seed)
    pt = time.perf_counter() - t0
    m = edge_partition_metrics(g, assignment, args.k)
    print(f"[gnn] partitioned in {pt:.2f}s ({args.partitioner}): "
          f"rf={m.replication_factor:.2f} "
          f"edge_bal={m.edge_balance:.2f} vertex_bal={m.vertex_balance:.2f}")
    tr = FullBatchTrainer.build(
        g, assignment, args.k, spec, feats, labels, train_mask,
        sync_mode=args.sync_mode, seed=args.seed, lr=args.lr, device=device)
    est = fullbatch_epoch(tr.book, spec)
    print(f"[gnn] paper-cluster epoch estimate: {est.epoch_time*1e3:.1f} ms, "
          f"comm {est.comm_bytes.sum()/2**20:.1f} MiB "
          f"(wire {est.wire_bytes.sum()/2**20:.1f} MiB, fp32), "
          f"mem max {est.memory.max()/2**20:.1f} MiB"
          + (" (OOM!)" if est.oom else ""))

    losses, seconds = [], []
    for epoch in range(args.epochs):
        t1 = time.perf_counter()
        loss = tr.train_step()  # returns a float: the step has ended
        seconds.append(time.perf_counter() - t1)
        losses.append(loss)
        print(f"[gnn] epoch {epoch:3d} loss {loss:.4f} "
              f"({seconds[-1]:.2f}s on {device})")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    if peak is not None:
        print(f"[gnn] peak device memory {peak / 2**30:.2f} GiB")
    return TrainRun(graph=g, spec=spec, assignment=assignment, trainer=tr,
                    estimate=est, losses=losses, step_seconds=seconds,
                    peak_memory=peak)


def main(argv: Optional[list] = None) -> None:
    # before anything starts CUDA; an allocator config of the caller's own
    # stands
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", TRAIN_ALLOC_CONF)
    run(argv)


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch port: partition a graph, train a GNN
distributed, verify the partitioning invariants, and inspect the paper's
core correlation — on the current knob set (aggregation backends, feature
cache). Twin of examples/quickstart.py, with the same printout.

Trains on `--device`: the card unless `--device cpu` is given (cuda raises
when no GPU is visible). The tiled backend is the CUDA segment-reduce
kernel on the card and its plain version on the CPU.

  PYTHONPATH=src python examples/torch_quickstart.py [--scale 0.05] [--k 8]
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu \\
      --scale 0.01 --k 2
"""

import argparse
import dataclasses

import numpy as np

from repro_torch.core import cost_model
from repro_torch.core.device import resolve_device
from repro_torch.core.edge_partition import partition_edges
from repro_torch.core.graph import paper_graph
from repro_torch.core.metrics import edge_partition_metrics
from repro_torch.core.vertex_partition import partition_vertices
from repro_torch.gnn.fullbatch import FullBatchTrainer
from repro_torch.gnn.minibatch import MiniBatchTrainer
from repro_torch.gnn.models import GNNSpec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args()
    k = args.k
    device = resolve_device(args.device)

    # 1. a graph from the paper's categories (Orkut-like social graph)
    g = paper_graph("OR", scale=args.scale, seed=0)
    print(f"graph: {g.num_vertices} vertices, {g.num_edges} edges")

    rng = np.random.default_rng(0)
    feats = rng.normal(size=(g.num_vertices, 64)).astype(np.float32)
    labels = rng.integers(0, 16, g.num_vertices).astype(np.int32)
    train = rng.random(g.num_vertices) < 0.3
    spec = GNNSpec(model="sage", feature_dim=64, hidden_dim=64, num_classes=16)

    # 2. the paper's comparison, in three lines per partitioner
    for method in ["random", "hdrf", "hep100"]:
        a = partition_edges(g, k, method, seed=1)
        m = edge_partition_metrics(g, a, k)
        tr = FullBatchTrainer.build(g, a, k, spec, feats, labels, train,
                                    sync_mode="halo", device=device)
        est = cost_model.fullbatch_epoch(tr.book, spec)
        loss = tr.train_step()
        print(f"{method:8s} rf={m.replication_factor:5.2f} "
              f"sync_traffic={tr.comm_bytes_per_epoch()/2**20:7.1f} MiB "
              f"cluster_epoch={est.epoch_time*1e3:7.1f} ms  loss={loss:.4f}")

    # 3. the invariants that make the system safe to scale:
    #    (a) distributed == single-machine forward, and (b) the tiled
    #    aggregation backend (agg_backend, the segment-reduce kernel's
    #    layout) == the scatter oracle — so partitioning and kernel choice
    #    never change the math
    ref = FullBatchTrainer.build(
        g, np.zeros(g.num_edges, np.int32), 1, spec, feats, labels, train,
        device=device)
    a = partition_edges(g, k, "hep100", seed=1)
    tr = FullBatchTrainer.build(g, a, k, spec, feats, labels, train,
                                device=device)
    err = np.abs(tr.forward_logits_global() - ref.forward_logits_global()).max()
    print(f"distributed == single-machine forward: max err {err:.2e}")

    tiled = FullBatchTrainer.build(
        g, a, k, dataclasses.replace(spec, agg_backend="tiled"),
        feats, labels, train, device=device)
    err = np.abs(tiled.forward_logits_global() - ref.forward_logits_global()).max()
    print(f"tiled agg backend == scatter oracle:    max err {err:.2e}")

    # 4. the DistDGL regime with a feature cache (cache_policy): remote
    #    misses — the bytes that cross the network — drop when hot remote
    #    vertices are cached
    owner = partition_vertices(g, k, "metis", seed=1)
    for policy, budget in (("none", 0), ("degree", g.num_vertices // 10)):
        mb = MiniBatchTrainer.build(
            g, owner, k, spec, feats, labels, train, device=device,
            global_batch=128, seed=2, cache_policy=policy,
            cache_budget=budget)
        sm = mb.train_step()
        mb.close()
        print(f"minibatch cache={policy:6s} remote={int(sm.remote_vertices.sum()):5d} "
              f"hit_rate={sm.hit_rate:.2f} "
              f"miss_bytes={int(sm.miss_bytes.sum()):8d}  loss={sm.loss:.4f}")


if __name__ == "__main__":
    main()

"""End-to-end driver on the PyTorch port: the paper's study on one graph —
partition with all 12 algorithms, score both training regimes (the
mini-batch side with the feature cache on), and the serving regime the
training study feeds. Twin of examples/gnn_partitioning_study.py, with
the same printout.

The training rows are the cost model over real partitions and sampled
batches, computed on the host; the serving rows run layer-wise inference
and the served micro-batches on `--device` (the card unless `--device cpu`
is given; cuda raises when no GPU is visible). `--agg-backend` takes the
reference's names: scatter, tiled (the CUDA segment-reduce kernel on the
card, its plain version on the CPU) and pallas (the port's name for
"always the kernel": on the CPU it raises).

  PYTHONPATH=src python examples/torch_gnn_partitioning_study.py [--scale 0.05]
  PYTHONPATH=src python examples/torch_gnn_partitioning_study.py \\
      --device cpu --scale 0.01 --k 2
"""

import argparse

from repro_torch.core.study import (
    EDGE_METHODS,
    VERTEX_METHODS,
    fullbatch_row,
    fullbatch_speedup,
    minibatch_row,
    minibatch_speedup,
    serve_row,
)
from repro_torch.gnn.models import GNNSpec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--graph", default="OR")
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--agg-backend", default="scatter",
                    choices=["scatter", "tiled", "pallas"])
    ap.add_argument("--cache-policy", default="degree",
                    choices=["none", "random", "degree", "halo"])
    args = ap.parse_args()

    spec = GNNSpec(model="sage", feature_dim=512, hidden_dim=64,
                   num_classes=16, num_layers=3,
                   agg_backend=args.agg_backend)

    print(f"== DistGNN regime (full-batch, edge partitioning), "
          f"{args.graph} x{args.scale}, k={args.k}")
    rows = [fullbatch_row(args.graph, m, args.k, spec, scale=args.scale)
            for m in EDGE_METHODS]
    for r in sorted(fullbatch_speedup(rows), key=lambda r: -r["speedup"]):
        print(f"  {r['method']:8s} rf={r['rf']:6.2f} "
              f"speedup={r['speedup']:5.2f}x mem%={r['memory_pct_random']:5.1f} "
              f"amortize={r['amortize_epochs']:6.2f} epochs")

    print(f"== DistDGL regime (mini-batch, vertex partitioning), "
          f"feature cache policy={args.cache_policy}")
    budget = 0 if args.cache_policy == "none" else 200
    rows = [minibatch_row(args.graph, m, args.k, spec, scale=args.scale,
                          global_batch=128, steps=2, run_device_step=False,
                          cache_policy=args.cache_policy, cache_budget=budget,
                          device=args.device)
            for m in VERTEX_METHODS]
    for r in sorted(minibatch_speedup(rows), key=lambda r: -r["speedup"]):
        print(f"  {r['method']:8s} cut={r['edge_cut']:5.3f} "
              f"speedup={r['speedup']:5.2f}x net%={r['net_pct_random']:5.1f} "
              f"hit_rate={r['hit_rate']:.2f} "
              f"remote/step={r['remote_vertices']:7.0f}")

    print("== serving regime (layer-wise embeddings + micro-batched requests)")
    serve_spec = GNNSpec(model="sage", feature_dim=64, hidden_dim=256,
                         num_classes=16, num_layers=2,
                         agg_backend=args.agg_backend)
    for m in ("random", "metis"):
        r = serve_row(args.graph, m, min(args.k, 4), serve_spec,
                      scale=args.scale, qps=200.0, n_requests=160,
                      cache_policy=args.cache_policy, cache_budget=budget,
                      device=args.device)
        print(f"  {m:8s} cut={r['partition_quality']:5.3f} "
              f"p50={r['latency_p50']*1e3:6.2f}ms "
              f"p99={r['latency_p99']*1e3:6.2f}ms "
              f"hit_rate={r['hit_rate']:.2f} "
              f"miss={r['miss_bytes']/2**20:6.2f} MiB "
              f"sustainable={r['qps_sustainable']:7.0f} qps")


if __name__ == "__main__":
    main()

"""The training CLI: partition a graph, train a GNN over the partitions.

Twin of repro/launch/gnn_train.py, both regimes, every wire codec:

  --regime fullbatch  DistGNN-style: edge partitioning, replica sync over
                      the stacked partitions (`--sync-mode` halo, dense,
                      or ring over contiguous block rows); one step is one
                      epoch
  --regime minibatch  DistDGL-style: vertex partitioning, per-worker
                      sampling and feature loading (gnn/pipeline.py, serial
                      or `--overlap`), `train_count // batch` steps an epoch

It prints what the reference prints: the graph, the partitioning time with
its quality metrics, the paper-cluster estimate (`fullbatch_epoch` /
`minibatch_step`: modeled, not a device time) and per epoch the loss
(mini batch: with remote vertices a step, the cache hit rate and, under
`--overlap`, the overlap efficiency); besides, the measured seconds on the
device: each step's (mini batch: with its host phases) and the warm step.

Runs on the card unless `--device cpu` is given; with `--device cuda` and
no GPU it raises. Features, labels and the training mask are drawn from
`np.random.default_rng(seed)` in the reference's order, so both CLIs train
on the same data from the same weights. `--codec` sets the wire codec
(core/wire.py) of every byte-moving path: the replica sync and the
gradient reduce (full batch), the feature fetch and the gradient reduce
(mini batch); `set_epoch` advances the variable codec's schedule each
epoch. `--trace PATH` installs the tracer (obs/trace.py) for the run and
writes its timeline to PATH (Chrome trace-event JSON, schema
gnn-trace/v1) and the measured-vs-model reconciliation to
PATH.report.json (obs/reconcile.py; fault accounting too under
`--inject-fault`). Study rows (`--out-json`, ROADMAP queue 1, item 2) are
not yet ported and are refused.

Robustness, as the reference CLI has it: `--ckpt-dir` checkpoints params,
optimizer state, the lossy codec's EF carry and the run coordinates (full
batch each epoch, mini batch each global step, every `--ckpt-every`,
keeping `--ckpt-keep`; ckpt/checkpoint.py, the reference's on-disk
format); `--resume` restores the newest complete checkpoint and continues
from the step after it: bit for bit the uninterrupted run's steps wherever
a step repeats (both regimes' steps run under PyTorch's deterministic
algorithms, `minibatch.repeatable_step`, on every backend and device);
`--inject-fault SPEC` (repeatable, fault/plan.py grammar) injects
deterministic faults: `crash@step:N` kills the run at step N (full batch:
epoch N), `sample-error` / `fetch-error` / `straggler` are retried or
absorbed in the mini-batch pipeline, `corrupt-ckpt` breaks the newest
checkpoint before `--resume` reads it (restore falls back to the one
before). An unknown spec exits 1 naming the valid kinds. An injected crash
prints the FATAL line and the `--resume` hint; `run` then raises
`WorkerCrash` (so callers in process see it), and `main` turns it into
exit code 3 (`CRASH_EXIT`).

  PYTHONPATH=src python -m repro_torch.launch.gnn_train --graph OR \\
      --scale 0.05 --partitioner hep100 --k 4 --model sage --epochs 5
  PYTHONPATH=src python -m repro_torch.launch.gnn_train --graph OR \\
      --scale 0.05 --k 4 --model gat --sync-mode ring --epochs 5
  PYTHONPATH=src python -m repro_torch.launch.gnn_train --graph OR \\
      --scale 0.05 --partitioner metis --k 4 --regime minibatch --batch 256
  PYTHONPATH=src python -m repro_torch.launch.gnn_train --graph OR \\
      --scale 0.05 --k 4 --ckpt-dir ck --inject-fault crash@step:2  # exit 3
  PYTHONPATH=src python -m repro_torch.launch.gnn_train --graph OR \\
      --scale 0.05 --k 4 --ckpt-dir ck --resume
  PYTHONPATH=src python -m repro_torch.launch.gnn_train --graph OR \\
      --scale 0.05 --k 4 --trace trace.json   # + trace.json.report.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Any, Optional, Union

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (
    CheckpointManager,
    checkpoint_extra,
    tree_nbytes,
)
from repro_torch.core.cost_model import (
    FullBatchEstimate,
    MiniBatchEstimate,
    fullbatch_epoch,
    minibatch_step,
)
from repro_torch.core.device import DEVICES, resolve_device
from repro_torch.core.edge_partition import EDGE_PARTITIONERS, partition_edges
from repro_torch.core.graph import Graph, paper_graph
from repro_torch.core.metrics import (
    edge_partition_metrics,
    vertex_partition_metrics,
)
from repro_torch.core.vertex_partition import (
    VERTEX_PARTITIONERS,
    partition_vertices,
)
from repro_torch.core.wire import CODECS
from repro_torch.fault import (
    FAULT_KINDS,
    FaultInjector,
    FaultPlan,
    FaultSpecError,
    WorkerCrash,
    corrupt_latest_checkpoint,
)
from repro_torch.gnn.feature_store import CACHE_POLICIES
from repro_torch.gnn.fullbatch import FullBatchTrainer
from repro_torch.gnn.minibatch import MiniBatchTrainer, StepMetrics
from repro_torch.gnn.models import GNNSpec
from repro_torch.gnn.sync import SYNC_MODES
from repro_torch.obs import Tracer, get_tracer, install, reconcile, write_trace

# The caching allocator's setting for training on the card. The tiled
# layout's temporaries (tens of GiB, a different size at each layer)
# fragment fixed segments: GAT at OR 1.0, widths 512, which peaks at 53 GiB
# of the 80 GB card, ran out of memory on them with 28 GiB reserved but
# free. The allocator reads it once, when CUDA starts, so `main` sets it for
# the process; a library caller of `run` chooses its own.
TRAIN_ALLOC_CONF = "expandable_segments:True"
# each regime's Adam step size when --lr is not given: the reference
# trainers' defaults (FullBatchTrainer.build 1e-2, MiniBatchTrainer.build
# 1e-3; the reference CLI passes neither)
DEFAULT_LR = {"fullbatch": 1e-2, "minibatch": 1e-3}
CRASH_EXIT = 3  # injected worker crash (distinct from real failures)
# the reference CLI's flags this port refuses, with the ROADMAP queue 1
# item that ports them; the parser does not know them either
NOT_PORTED = {"--out-json": "study rows: ROADMAP queue 1, item 2"}


def refuse_not_ported(argv: list, flags) -> None:
    """Raise NotImplementedError, naming its ROADMAP item, for the first
    of `flags` (keys of NOT_PORTED) that `argv` passes."""
    for arg in argv:
        flag = arg.split("=", 1)[0]
        if flag in flags:
            raise NotImplementedError(
                f"{flag} ({NOT_PORTED[flag]}) is not yet ported")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.gnn_train",
        description="Partition a graph and train a GNN over the partitions "
                    "(full batch with replica sync, or mini batch with "
                    "sampling and feature loading).")
    ap.add_argument("--device", default="cuda", choices=list(DEVICES),
                    help="where the model trains; cuda raises if no GPU is "
                         "visible")
    ap.add_argument("--graph", default="OR", choices=["HO", "DI", "EN", "EU", "OR"])
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--partitioner", default="hep100",
                    help="edge partitioner (full batch; ring forces "
                         "blockrow) or vertex partitioner (mini batch)")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--model", default="sage", choices=["sage", "gcn", "gat"])
    ap.add_argument("--regime", default="fullbatch",
                    choices=["fullbatch", "minibatch"],
                    help="fullbatch: DistGNN-style; minibatch: DistDGL-style")
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--features", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--batch", type=int, default=256,
                    help="global mini-batch (seed vertices a step over all "
                         "workers; mini batch)")
    ap.add_argument("--sync-mode", default="halo", choices=list(SYNC_MODES),
                    help="full-batch sync strategy (gnn/sync.py): halo: "
                         "static-routed replica exchange; dense: the global "
                         "sum baseline (a [V+1, d] buffer a partition, "
                         "summed); ring: 1.5D block rotation over "
                         "contiguous block rows (ignores --partitioner: the "
                         "blockrow layout needs no partitioning pass); "
                         "local: no exchange (the k=1 oracle; at k > 1 the "
                         "partial aggregates stay partial)")
    ap.add_argument("--agg-backend", default="scatter",
                    choices=["scatter", "tiled", "pallas"],
                    help="scatter: index_add_/scatter_reduce_; tiled: the "
                         "CUDA segment-reduce kernel on the card (its plain "
                         "version on the CPU); pallas: always the kernel")
    ap.add_argument("--rebalance", action="store_true",
                    help="dynamic seed rebalancing (straggler mitigation; "
                         "mini batch)")
    ap.add_argument("--overlap", action="store_true",
                    help="pipelined mini-batch execution (gnn/pipeline.py): "
                         "sampling, feature loading and the copy for step "
                         "t+1 run on a producer thread while the device "
                         "computes step t; same batches as serial")
    ap.add_argument("--prefetch-depth", type=int, default=2,
                    help="batches prepared ahead of the device step "
                         "(bounded queue; only read with --overlap)")
    ap.add_argument("--cache-policy", default="none",
                    choices=list(CACHE_POLICIES),
                    help="per-worker remote-feature cache policy (mini batch)")
    ap.add_argument("--cache-budget", type=int, default=0,
                    help="cached remote vertices per worker (mini batch)")
    ap.add_argument("--codec", default="fp32", choices=list(CODECS),
                    help="wire codec (core/wire.py) of the byte-moving "
                         "paths: replica sync + gradient reduce (full "
                         "batch), feature fetch + gradient reduce (mini "
                         "batch). fp32 is exact; int8 adds error feedback "
                         "on gradients; variable ramps the ratio by layer "
                         "and epoch")
    ap.add_argument("--lr", type=float, default=None,
                    help="Adam step size; default the reference trainer's "
                         "(full batch 1e-2, mini batch 1e-3). At widths 512 "
                         "full batch diverges at 1e-2; 1e-3, the default of "
                         "Adam's paper (Kingma & Ba, ICLR 2015, Algorithm "
                         "1), does not")
    ap.add_argument("--trace", default="", metavar="PATH",
                    help="record the run's span/counter timeline to PATH "
                         "(Chrome trace-event JSON, schema gnn-trace/v1; "
                         "open in https://ui.perfetto.dev or "
                         "chrome://tracing) and write the measured-vs-"
                         "model reconciliation report to PATH.report.json")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory (ckpt/checkpoint.py: atomic "
                         "step_<n>/ dirs, keep-last-k). Saves params + "
                         "optimizer + codec EF carry + run coordinates")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="checkpoint cadence: epochs (full batch) resp. "
                         "global steps (mini batch) between saves")
    ap.add_argument("--ckpt-keep", type=int, default=3,
                    help="complete checkpoints retained (older ones GC'd)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest complete checkpoint in "
                         "--ckpt-dir and continue from the step after it; "
                         "where the step repeats, the resumed steps are "
                         "the uninterrupted run's, bit for bit")
    ap.add_argument("--inject-fault", action="append", default=[],
                    metavar="SPEC",
                    help="deterministic fault injection (repeatable), "
                         "kind@key:value[,key:value...], e.g. "
                         "crash@step:3, sample-error@step:2,worker:1, "
                         "straggler@step:1,delay:0.05, corrupt-ckpt. "
                         f"Kinds: {', '.join(FAULT_KINDS)}")
    ap.add_argument("--seed", type=int, default=0)
    return ap


@dataclasses.dataclass
class TrainRun:
    """What one `run` produced, for callers that check it."""

    graph: Graph
    spec: GNNSpec
    assignment: np.ndarray       # the edge (full batch) / vertex partition
    trainer: Union[FullBatchTrainer, MiniBatchTrainer]
    # modeled on the paper's cluster; mini batch: the last epoch's last step
    estimate: Union[FullBatchEstimate, MiniBatchEstimate]
    losses: list                 # per step, before its update (full batch:
                                 # one step an epoch)
    step_seconds: list           # host clock around each step, synced
    peak_memory: Optional[int]   # bytes, torch.cuda.max_memory_allocated
                                 # over the run; None on the CPU
    step_metrics: list = dataclasses.field(default_factory=list)
    # mini batch: each step's `StepMetrics`
    start_step: int = 0          # the first step trained (full batch: the
                                 # epoch); > 0 after --resume
    checkpoints: Any = None      # `RunCheckpoints` under --ckpt-dir
    fault_plan: Any = None       # the --inject-fault plan, if any
    tracer: Any = None           # the run's `obs.Tracer` under --trace
    trace_report: Any = None     # its `obs.reconcile.ReconcileReport`


def run(argv: Optional[list] = None) -> TrainRun:
    """Parse `argv` (default: sys.argv[1:]) and train; prints a report."""
    argv = sys.argv[1:] if argv is None else argv
    refuse_not_ported(argv, NOT_PORTED)
    args = parser().parse_args(argv)
    allowed = (EDGE_PARTITIONERS if args.regime == "fullbatch"
               else VERTEX_PARTITIONERS)
    if args.partitioner not in allowed:
        kind = ("full batch (DistGNN) uses edge" if args.regime == "fullbatch"
                else "mini batch (DistDGL) uses vertex")
        raise ValueError(f"{kind} partitioners: {sorted(allowed)}; got "
                         f"{args.partitioner!r}")
    lr = DEFAULT_LR[args.regime] if args.lr is None else args.lr
    plan = None
    if args.inject_fault:
        try:
            plan = FaultPlan.parse(args.inject_fault, seed=args.seed)
        except FaultSpecError as e:
            print(f"[gnn] bad --inject-fault: {e}")
            sys.exit(1)
        print(f"[gnn] fault plan: "
              f"{'; '.join(ev.describe() for ev in plan.events)}")
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    # the tracer is the process's for the run, and only for it
    prev = get_tracer()
    tracer = install(Tracer()) if args.trace else None
    try:
        g, feats, labels, train_mask, spec = problem(args)
        ckpt = RunCheckpoints(args, plan) if args.ckpt_dir else None
        train = _minibatch if args.regime == "minibatch" else _fullbatch
        try:
            out = train(args, device, lr, g, spec, feats, labels,
                        train_mask, ckpt, plan)
        except WorkerCrash as e:
            print(f"[gnn] FATAL: {e}")
            if args.ckpt_dir:
                print(f"[gnn] resume: re-run with --resume "
                      f"(checkpoints in {args.ckpt_dir})")
            raise
        out.checkpoints, out.fault_plan = ckpt, plan
        if out.peak_memory is not None:
            print(f"[gnn] peak device memory "
                  f"{out.peak_memory / 2**30:.2f} GiB")
        if tracer is not None:
            if args.regime == "fullbatch":
                checks = reconcile.reconcile_fullbatch(out.trainer,
                                                       tracer=tracer)
            else:
                checks = reconcile.reconcile_minibatch(
                    out.trainer, out.step_metrics, tracer=tracer)
            if plan is not None:
                checks += reconcile.reconcile_recovery(plan, tracer=tracer)
            out.tracer = tracer
            out.trace_report = write_traced_run("gnn", args.trace, tracer,
                                                checks)
        return out
    finally:
        install(prev)


def write_traced_run(tag: str, path: str, tracer, checks):
    """Write `tracer`'s timeline to `path` and the reconciliation report
    of `checks` to `path`.report.json; print its counts and every error.
    Returns the report."""
    report = reconcile.build_report(checks)
    write_trace(path, tracer)
    with open(path + ".report.json", "w") as fh:
        json.dump(report.to_dict(), fh, indent=2)
        fh.write("\n")
    c = report.counts
    print(f"[{tag}] trace -> {path} "
          f"(report {path}.report.json: {c.get('ok', 0)} ok, "
          f"{c.get('warn', 0)} warn, {c.get('error', 0)} error)")
    for ch in report.checks:
        if ch.level == "error":
            print(f"  [error] {ch.quantity}: {ch.message}")
    return report


def problem(args: argparse.Namespace):
    """(graph, features, labels, train mask, spec) of parsed `args`: the
    reference CLI's draws from `np.random.default_rng(seed)`, in its
    order."""
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
    return g, feats, labels, train_mask, spec


class RunCheckpoints:
    """A run's checkpoint side: a `CheckpointManager` over --ckpt-dir, the
    corrupt-ckpt fault fired before a resume reads the directory, and the
    bytes a save holds, the seconds of every save and of the restore, and
    the step restored (host clock, the device-to-host copy included)."""

    def __init__(self, args: argparse.Namespace, plan) -> None:
        self.dir = args.ckpt_dir
        self.resume = args.resume
        self.plan = plan
        self.manager = CheckpointManager(self.dir, keep=args.ckpt_keep,
                                         every=args.ckpt_every)
        self.nbytes = 0
        self.save_seconds: list = []
        self.resumed_from: Optional[int] = None
        self.restore_seconds: Optional[float] = None
        if plan is not None and self.resume:
            # corrupt-ckpt: break the newest checkpoint BEFORE restore reads
            # it — restore must fall back to the previous complete one
            for ev in plan.pending("corrupt-ckpt"):
                if plan.fire(ev):
                    path = corrupt_latest_checkpoint(self.dir)
                    print(f"[gnn] injected checkpoint corruption -> {path}")

    def extra(self) -> tuple[Optional[int], dict]:
        """(step, run coordinates) of the checkpoint a resume restores;
        (None, {}) when not resuming or there is none."""
        return checkpoint_extra(self.dir) if self.resume else (None, {})

    def restore(self, tr, extra: dict) -> Optional[int]:
        """Restore the newest complete checkpoint into trainer `tr` (its EF
        carry too when the checkpoint has one); returns its step, or None
        when there is none (the run starts fresh)."""
        if not self.resume:
            return None
        tree = {"params": tr.params, "opt_state": tr.opt_state}
        if extra.get("has_ef"):
            tr.ef_state = tr._init_ef()
            tree["ef"] = tr.ef_state
        t0 = time.perf_counter()
        step, restored = self.manager.restore(tree)
        self.restore_seconds = time.perf_counter() - t0
        if self.plan is not None:
            # a corrupt-ckpt fault is handled once restore fell back
            for ev in self.plan.fired_events():
                if ev.kind == "corrupt-ckpt":
                    self.plan.mark_handled(ev)
        if step is None:
            print("[gnn] --resume: no complete checkpoint found, "
                  "starting fresh")
            return None
        tr.params = restored["params"]
        tr.opt_state = restored["opt_state"]
        if "ef" in restored:
            tr.ef_state = restored["ef"]
        self.resumed_from = step
        return step

    def save(self, step: int, tr, extra: dict) -> None:
        tree = {"params": tr.params, "opt_state": tr.opt_state}
        if tr.ef_state is not None:
            tree["ef"] = tr.ef_state
        t0 = time.perf_counter()
        path = self.manager.maybe_save(
            step, tree, extra={**extra, "has_ef": tr.ef_state is not None})
        if path is not None:
            self.save_seconds.append(time.perf_counter() - t0)
            self.nbytes = tree_nbytes(tree)
            print(f"[gnn] checkpoint {os.path.basename(path)}: "
                  f"{self.nbytes / 2**20:.2f} MiB in "
                  f"{self.save_seconds[-1]:.3f}s")


def _peak(device: torch.device) -> Optional[int]:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)


def _fullbatch(args, device, lr, g, spec, feats, labels, train_mask, ckpt,
               plan) -> TrainRun:
    partitioner = args.partitioner
    if args.sync_mode == "ring":
        # 1.5D: contiguous blockrow layout, no partitioning heuristic — the
        # near-zero partition time is the regime's selling point
        partitioner = "blockrow"
    t0 = time.perf_counter()
    assignment = partition_edges(g, args.k, partitioner, seed=args.seed)
    pt = time.perf_counter() - t0
    m = edge_partition_metrics(g, assignment, args.k)
    print(f"[gnn] partitioned in {pt:.2f}s ({partitioner}): "
          f"rf={m.replication_factor:.2f} "
          f"edge_bal={m.edge_balance:.2f} vertex_bal={m.vertex_balance:.2f}")
    tr = FullBatchTrainer.build(
        g, assignment, args.k, spec, feats, labels, train_mask,
        sync_mode=args.sync_mode, seed=args.seed, lr=lr, codec=args.codec,
        device=device)
    est = fullbatch_epoch(tr.book, spec, codec=args.codec)
    print(f"[gnn] paper-cluster epoch estimate: {est.epoch_time*1e3:.1f} ms, "
          f"comm {est.comm_bytes.sum()/2**20:.1f} MiB "
          f"(wire {est.wire_bytes.sum()/2**20:.1f} MiB, {args.codec}), "
          f"mem max {est.memory.max()/2**20:.1f} MiB"
          + (" (OOM!)" if est.oom else ""))

    start_epoch = 0
    if ckpt is not None:
        step_r, extra = ckpt.extra()
        if ckpt.restore(tr, extra) is not None:
            start_epoch = int(extra.get("epoch", step_r)) + 1
            print(f"[gnn] resumed from checkpoint epoch {step_r} "
                  f"-> continuing at epoch {start_epoch} (restore "
                  f"{ckpt.restore_seconds:.3f}s)")
    injector = FaultInjector(plan) if plan is not None else None
    losses, seconds = [], []
    for epoch in range(start_epoch, args.epochs):
        t1 = time.perf_counter()
        if injector is not None:
            injector.at_epoch(epoch)
        tr.set_epoch(epoch)
        loss = tr.train_step()  # returns a float: the step has ended
        seconds.append(time.perf_counter() - t1)
        losses.append(loss)
        print(f"[gnn] epoch {epoch:3d} loss {loss:.4f} "
              f"({seconds[-1]:.2f}s on {device})")
        if ckpt is not None:
            ckpt.save(epoch, tr, {"epoch": epoch})
    return TrainRun(graph=g, spec=spec, assignment=assignment, trainer=tr,
                    estimate=est, losses=losses, step_seconds=seconds,
                    peak_memory=_peak(device), start_step=start_epoch)


def _minibatch(args, device, lr, g, spec, feats, labels, train_mask, ckpt,
               plan) -> TrainRun:
    t0 = time.perf_counter()
    assignment = partition_vertices(g, args.k, args.partitioner,
                                    seed=args.seed, train_mask=train_mask)
    pt = time.perf_counter() - t0
    m = vertex_partition_metrics(g, assignment, args.k, train_mask)
    print(f"[gnn] partitioned in {pt:.2f}s: edge_cut={m.edge_cut:.3f} "
          f"vertex_bal={m.vertex_balance:.2f}")
    steps_per_epoch = max(int(train_mask.sum()) // args.batch, 1)
    next_step, extra = 0, {}
    if ckpt is not None:
        gstep, extra = ckpt.extra()
        if gstep is not None:
            next_step = gstep + 1          # first global step to draw
    tr = MiniBatchTrainer.build(
        g, assignment, args.k, spec, feats, labels, train_mask,
        device=device, global_batch=args.batch, seed=args.seed, lr=lr,
        rebalance=args.rebalance, cache_policy=args.cache_policy,
        cache_budget=args.cache_budget, overlap=args.overlap,
        prefetch_depth=args.prefetch_depth, codec=args.codec,
        start_step=next_step,
        injector=FaultInjector(plan) if plan is not None else None)
    start_epoch = next_step // steps_per_epoch
    if ckpt is not None:
        step_r = ckpt.restore(tr, extra)
        if step_r is not None:
            print(f"[gnn] resumed from checkpoint step {step_r} -> "
                  f"continuing at global step {next_step} (epoch "
                  f"{start_epoch}, step {next_step % steps_per_epoch}; "
                  f"restore {ckpt.restore_seconds:.3f}s)")
    if args.cache_budget:
        print(f"[gnn] feature cache: policy={args.cache_policy} "
              f"budget={args.cache_budget}/worker "
              f"(filled {tr.store.cache_sizes.tolist()})")
    sms: "list[StepMetrics]" = []
    est = None
    gstep = next_step
    try:
        for epoch in range(start_epoch, args.epochs):
            t1 = time.perf_counter()
            tr.set_epoch(epoch)
            epoch_sms = []
            first = gstep - epoch * steps_per_epoch
            for step in range(first, steps_per_epoch):
                sm = tr.train_step()
                epoch_sms.append(sm)
                print(f"[gnn]   step {gstep:4d} loss "
                      f"{sm.loss:.4f} wall {sm.step_wall_host:.4f}s: sample "
                      f"{sm.sample_time_host:.4f} fetch "
                      f"{sm.fetch_time_host:.4f} transfer "
                      f"{sm.transfer_time_host:.4f} compute "
                      f"{sm.compute_time_host:.4f} wait "
                      f"{sm.queue_wait_host:.4f} (s, host clock, {device})")
                if ckpt is not None:
                    ckpt.save(gstep, tr, {"epoch": epoch, "step": step})
                gstep += 1
            sms += epoch_sms
            est = minibatch_step(
                sm.input_vertices, sm.remote_vertices, sm.edges,
                tr.book.sizes, spec, remote_miss_vertices=sm.remote_misses,
                cached_vertices=tr.store.cache_sizes, codec=args.codec)
            overlap_note = ""
            if args.overlap:
                eff = np.mean([s.overlap_efficiency for s in epoch_sms])
                overlap_note = f"overlap_eff {eff:.2f} "
            # the run's first step is cold (allocator, kernel builds)
            warm = [s.step_wall_host for s in sms[1:]] or [sms[0].step_wall_host]
            print(f"[gnn] epoch {epoch:3d} loss "
                  f"{np.mean([s.loss for s in epoch_sms]):.4f} "
                  f"remote/step "
                  f"{np.mean([s.remote_vertices.sum() for s in epoch_sms]):.0f} "
                  f"hit_rate {np.mean([s.hit_rate for s in epoch_sms]):.2f} "
                  f"wire/step "
                  f"{np.mean([s.wire_bytes.sum() for s in epoch_sms])/2**20:.2f}"
                  f" MiB ({args.codec}) "
                  f"{overlap_note}"
                  f"cluster step est {est.step_time*1e3:.1f} ms (modeled) "
                  f"| warm step {np.median(warm):.4f}s on {device} "
                  f"({time.perf_counter()-t1:.2f}s)")
    finally:
        tr.close()
    return TrainRun(graph=g, spec=spec, assignment=assignment, trainer=tr,
                    estimate=est, losses=[s.loss for s in sms],
                    step_seconds=[s.step_wall_host for s in sms],
                    peak_memory=_peak(device), step_metrics=sms,
                    start_step=next_step)


def main(argv: Optional[list] = None) -> None:
    # before anything starts CUDA; an allocator config of the caller's own
    # stands
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", TRAIN_ALLOC_CONF)
    try:
        run(argv)
    except WorkerCrash:  # `run` printed the FATAL line and the hint
        sys.exit(CRASH_EXIT)


if __name__ == "__main__":
    main()

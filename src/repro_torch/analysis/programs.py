"""Representative programs the static analyzer runs its rules over.

The counterpart of repro/analysis/programs.py, with its program names, its
grid and its fixture. A `Program` is one (entry point x configuration)
cell plus the invariants the rules should hold it to. Four kinds:

  ops          `make()` returns a list of recorded programs: the ops one
               forward dispatched (analysis/dispatch.py), on `device`. Read
               by the no-scatter and dtype-policy rules. (The reference's
               `jaxpr`.)
  collectives  `make()` runs one sync aggregate with the tracer installed
               and returns the collectives the strategy recorded
               (`gnn.sync._record_collective`); held by the
               collective-budget rule to `budget()`, the prediction of
               `gnn.sync.collective_budget`. (The reference's `hlo`: eager
               PyTorch emits no HLO.)
  donation     `make()` returns (step, carries): the rule steps twice and
               asks whether any carry of the first step (params, Adam's
               mu / nu and step, the EF carry) is still alive. That is
               what `donate_argnums` buys the reference on the device; the
               port has no jit to declare it to.
  retrace      `sweep()` builds a FRESH trainer/engine and returns its hot
               loop. The retrace-guard rule runs it twice, the first run
               warming the process, and counts kernel builds and library
               loads during the second against `retrace_budget`.

The grid covers the paper's axes: {sage, gat} models x {scatter, tiled,
pallas} aggregation backends x {halo, ring, dense, local} sync strategies
x {fp32, int8, variable} wire codecs, over full-batch training, mini-batch
training, layer-wise inference and online serving. A `pallas` cell forces
the CUDA kernel: on a CPU device it is skipped (`skip`), as the
reference's budget rule skips a program that needs more devices.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.ops import scatter_free_traced

D = 8                 # feature/hidden width of every analysis program
K = 4                 # partitions for the distributed cells
NUM_CLASSES = 4

__all__ = ["Program", "build_programs", "violation_program", "GRIDS"]


@dataclasses.dataclass
class Program:
    """One analyzed program + the invariants rules hold it to."""

    name: str
    kind: str                               # ops | collectives | donation | retrace
    make: Optional[Callable[[], Any]] = None   # artifact builder (lazy)
    meta: dict = dataclasses.field(default_factory=dict)
    device: torch.device = torch.device("cpu")
    # why the program cannot run on `device` (an info finding, no rule run)
    skip: Optional[str] = None
    # --- no-scatter rule (ops) ----------------------------------------------
    # True: accumulating ops must NOT appear; False: they MUST (anchor cell
    # proving the rule still sees them); None: report only.
    expect_scatter_free: Optional[bool] = None
    # --- dtype-policy rule (ops): codec governing allowed narrow dtypes -----
    codec: Optional[str] = None
    # --- collective-budget rule (collectives) -------------------------------
    budget: Optional[Callable[[], dict]] = None
    # --- retrace-guard rule ---------------------------------------------------
    sweep: Optional[Callable[[], Any]] = None
    retrace_budget: Optional[int] = None
    _artifact: Any = dataclasses.field(default=None, repr=False,
                                       compare=False)

    def artifact(self):
        """`make()`'s result, made once: both ops rules read it."""
        if self._artifact is None:
            self._artifact = self.make()
        return self._artifact


# ---------------------------------------------------------------------------
# Shared fixture (one small paper graph, cached per process)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=1)
def _fixture():
    from repro_torch.core.graph import paper_graph

    g = paper_graph("OR", scale=0.01, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(g.num_vertices, D)).astype(np.float32)
    labels = rng.integers(0, NUM_CLASSES, g.num_vertices).astype(np.int32)
    train = rng.random(g.num_vertices) < 0.3
    return g, feats, labels, train


@functools.lru_cache(maxsize=None)
def _assignment(k: int):
    from repro_torch.core.edge_partition import partition_edges

    return partition_edges(_fixture()[0], k, "hdrf", seed=1)


def _spec(model: str, backend: str):
    from repro_torch.gnn.models import GNNSpec

    return GNNSpec(model=model, feature_dim=D, hidden_dim=D,
                   num_classes=NUM_CLASSES, agg_backend=backend)


@functools.lru_cache(maxsize=None)
def _book_blocks(sync_mode: str, tiled: bool, k: int, device: torch.device):
    from repro_torch.gnn.fullbatch import build_book, build_device_blocks

    g, feats, labels, train = _fixture()
    if sync_mode == "ring":
        a = None
    elif k == 1:
        a = np.zeros(g.num_edges, np.int64)
    else:
        a = _assignment(k)
    book = build_book(g, a, k, sync_mode=sync_mode, tiled_layout=tiled)
    return book, build_device_blocks(book, feats, labels, train,
                                     device=device)


def _live_params(spec, device):
    """The model's seed-0 parameters as fresh leaves that want a gradient,
    as a training step's forward sees them (`optim.adam_step`)."""
    from repro_torch.gnn import models
    from repro_torch.optim import tree_map

    return tree_map(lambda t: t.requires_grad_(),
                    models.init_params(spec, seed=0, device=device))


# ---------------------------------------------------------------------------
# ops builders (record one forward; nothing steps)
# ---------------------------------------------------------------------------


def _record_loss(fn, *args) -> list:
    """The ops of a training forward: grad enabled, no backward (the
    reference traces `loss`, not its gradient), under the step's
    deterministic mode."""
    from repro_torch.analysis.dispatch import record
    from repro_torch.gnn.minibatch import repeatable_step

    with repeatable_step():
        return [record(fn, *args)]


def _fullbatch_ops(model: str, backend: str, sync_mode: str,
                   codec: Optional[str], k: int,
                   device: torch.device) -> list:
    from repro_torch.gnn.fullbatch import make_step_fns

    spec = _spec(model, backend)
    _, blocks = _book_blocks(sync_mode, backend != "scatter", k, device)
    loss, _ = make_step_fns(spec, sync_mode, k, codec=codec)
    return _record_loss(loss, _live_params(spec, device), blocks)


def _minibatch_trainer(spec, device, codec=None):
    from repro_torch.gnn.minibatch import MiniBatchTrainer

    g, feats, labels, train = _fixture()
    return MiniBatchTrainer.build(
        g, np.zeros(g.num_vertices, np.int64), 1, spec, feats, labels,
        train, device=device, global_batch=64, fanouts=(4, 4), seed=0,
        codec=codec,
    )


def _minibatch_ops(model: str, backend: str,
                   device: torch.device) -> list:
    from repro_torch.gnn.minibatch import minibatch_loss

    spec = _spec(model, backend)
    tr = _minibatch_trainer(spec, device)
    try:
        # one worker (k=1): the stacked batch is worker 0's first batch
        stacked = tr.engine.preparer.prepare().stacked
        return _record_loss(
            functools.partial(minibatch_loss, spec), _live_params(spec, device),
            stacked, tuple(tr._layer_sizes))
    finally:
        tr.close()


def _serving(spec, device):
    from repro_torch.core.partition_book import build_vertex_book
    from repro_torch.gnn import models
    from repro_torch.serve.engine import build_serving

    g, feats, labels, train = _fixture()
    params = models.init_params(spec, seed=0, device=device)
    vbook = build_vertex_book(g, np.zeros(g.num_vertices, np.int64), 1)
    embeddings = [np.zeros((g.num_vertices, dout), np.float32)
                  for _, dout in spec.dims()]
    engines, batchers, _ = build_serving(
        g, vbook, spec, params, embeddings, device=device, hops=1, fanout=4,
        max_batch=8,
    )
    return engines[0], batchers[0]


def _serving_ops(model: str, backend: str, device: torch.device) -> list:
    from repro_torch.analysis.dispatch import record
    from repro_torch.gnn.minibatch import mfg_forward

    spec = _spec(model, backend)
    eng, bat = _serving(spec, device)
    batch = bat.build_mfg(np.arange(4, dtype=np.int64))
    x = np.zeros((batch.input_ids.shape[0], eng.store.row_dim), np.float32)
    dev = eng.device_batch(batch, x)
    # what `ServeEngine.answer` runs: inference mode, where `aggregate`
    # takes the forward without its autograd Function
    with torch.inference_mode():
        return [record(mfg_forward, spec, eng._layer_params, dev, eng._sizes)]


def _inference_ops(model: str, backend: str, k: int,
                   device: torch.device) -> list:
    from repro_torch.analysis.dispatch import OpRecorder
    from repro_torch.gnn import models
    from repro_torch.gnn.inference import LayerwiseInference

    g, feats, labels, train = _fixture()
    spec = _spec(model, backend)
    params = models.init_params(spec, seed=0, device=device)
    a = _assignment(k) if k > 1 else np.zeros(g.num_edges, np.int64)
    eng = LayerwiseInference.build(g, a, k, spec, params, feats,
                                   device=device, sync_mode="halo")
    traces = []
    # each layer as `LayerwiseInference.run` calls it, under inference mode
    with torch.inference_mode():
        states = eng.blocks.x
        for li in range(spec.num_layers):
            with OpRecorder() as rec:
                states = eng.layer(li, states)
            traces.append(rec.ops)
    return traces


# ---------------------------------------------------------------------------
# collectives builders (one sync aggregate with the tracer installed)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ring_fixture(device: torch.device):
    from repro_torch.core.partition_book import build_blockrow_book
    from repro_torch.gnn.sync import build_ring_blocks

    g, feats, _, _ = _fixture()
    zeros = np.zeros(g.num_vertices, np.int32)
    book = build_blockrow_book(g, K)
    return book, build_ring_blocks(book, feats, zeros, zeros.astype(bool),
                                   device=device)


@functools.lru_cache(maxsize=None)
def _halo_fixture(device: torch.device):
    from repro_torch.core.partition_book import build_edge_book
    from repro_torch.gnn.sync import build_blocks

    g, feats, _, _ = _fixture()
    zeros = np.zeros(g.num_vertices, np.int32)
    book = build_edge_book(g, _assignment(K), K)
    return book, build_blocks(book, feats, zeros, zeros.astype(bool),
                              device=device)


def _ring_collectives(codec: Optional[str], device: torch.device) -> list:
    from repro_torch.gnn.sync import RingSync
    from repro_torch.obs.trace import tracing

    _, blk = _ring_fixture(device)
    with tracing() as tr:
        RingSync(codec=codec).edge_aggregate(
            blk, blk.x, lambda s, dst, m: s * m[:, None])
    return tr.collectives()


def _partial_agg_collectives(mode: str, codec: Optional[str],
                             device: torch.device) -> list:
    from repro_torch.gnn.sync import make_sync
    from repro_torch.obs.trace import tracing

    _, blk = _halo_fixture(device)
    sync = make_sync(mode, blk, codec=codec)
    with tracing() as tr:
        # one reduce + broadcast; both complete in place, so on a copy of
        # the cached features
        sync.broadcast(sync.reduce_sum(blk.x.clone()))
    return tr.collectives()


def _sync_budget(mode: str, codec: Optional[str],
                 device: torch.device) -> dict:
    from repro_torch.gnn.sync import collective_budget

    book = (_ring_fixture(device) if mode == "ring"
            else _halo_fixture(device))[0]
    return collective_budget(book, D, mode, codec=codec)


# ---------------------------------------------------------------------------
# donation + retrace builders
# ---------------------------------------------------------------------------


def _fresh_fullbatch(codec: Optional[str], device: torch.device):
    from repro_torch.gnn.fullbatch import FullBatchTrainer

    g, feats, labels, train = _fixture()
    return FullBatchTrainer.build(
        g, np.zeros(g.num_edges, np.int64), 1, _spec("sage", "scatter"),
        feats, labels, train, seed=0, codec=codec, device=device,
    )


def _carries(tr) -> dict:
    """{name: tensor} of every carry a step replaces: params, Adam's
    mu / nu / step, and the EF carry (lossy codecs, after a step)."""
    from repro_torch.optim import leaves

    trees = {"params": tr.params, "mu": tr.opt_state.mu,
             "nu": tr.opt_state.nu}
    if tr.ef_state is not None:
        trees["ef"] = tr.ef_state
    out = {f"{name}[{i}]": t for name, tree in trees.items()
           for i, t in enumerate(leaves(tree))}
    out["step"] = tr.opt_state.step
    return out


def _donation_fullbatch(codec: str, device: torch.device):
    tr = _fresh_fullbatch(codec, device)
    return tr.train_step, functools.partial(_carries, tr)


def _donation_minibatch(codec: Optional[str], device: torch.device):
    tr = _minibatch_trainer(_spec("sage", "scatter"), device, codec=codec)
    return tr.train_step, functools.partial(_carries, tr)


def _sweep_fullbatch_fp32(device: torch.device):
    tr = _fresh_fullbatch(None, device)

    def hot():
        for _ in range(3):
            tr.train_step()

    return hot


def _sweep_fullbatch_variable(device: torch.device):
    tr = _fresh_fullbatch("variable", device)

    def hot():
        for epoch in range(4):
            tr.set_epoch(epoch)
            tr.train_step()

    return hot


def _sweep_minibatch_variable(device: torch.device):
    tr = _minibatch_trainer(_spec("sage", "scatter"), device,
                            codec="variable")

    def hot():
        for epoch in range(4):
            tr.set_epoch(epoch)
            tr.train_step()

    return hot


# each serving sweep presents a spec the process has never served (a new
# logits width), as the reference's does to defeat its step cache: a new
# shape must build nothing either
_SERVE_SPIN = itertools.count(1)


def _sweep_serving(device: torch.device):
    spec = dataclasses.replace(_spec("sage", "scatter"),
                               num_classes=NUM_CLASSES + next(_SERVE_SPIN))
    eng, bat = _serving(spec, device)

    def hot():
        for ids in (np.arange(4, dtype=np.int64),
                    np.arange(4, 10, dtype=np.int64)):
            eng.answer(bat.build_mfg(ids))

    return hot


# ---------------------------------------------------------------------------
# Grid assembly
# ---------------------------------------------------------------------------

MODELS = ("sage", "gat")
BACKENDS = ("scatter", "tiled")
SYNCS = ("halo", "ring")
WIRE_CODECS = ("fp32", "int8")

GRIDS = ("tiny", "smoke")


def _expect_free(backend: str, sync_mode: str, k: int, device) -> bool:
    """A recorded program is scatter-free iff the aggregation backend
    avoids scatter on `device` AND the sync strategy does (halo/dense
    complete with an index_add_ per sender at k>1)."""
    return (scatter_free_traced(backend, device)
            and (sync_mode == "ring" or k == 1))


def _ops_program(name: str, make, meta: dict, device: torch.device, *,
                 expect_scatter_free: bool, codec: str = "fp32") -> Program:
    skip = None
    if meta.get("backend") == "pallas" and device.type != "cuda":
        skip = ("needs the card: backend 'pallas' launches the CUDA "
                f"kernel, and this run is on {device}")
    return Program(name=name, kind="ops", make=make, meta=meta,
                   device=device, skip=skip,
                   expect_scatter_free=expect_scatter_free, codec=codec)


def _fullbatch_program(model, backend, sync_mode, codec, device,
                       k=K) -> Program:
    return _ops_program(
        f"fullbatch/{model}-{backend}-{sync_mode}-{codec or 'fp32'}-k{k}",
        functools.partial(_fullbatch_ops, model, backend, sync_mode, codec,
                          k, device),
        {"entry": "fullbatch", "model": model, "backend": backend,
         "sync": sync_mode, "k": k},
        device, expect_scatter_free=_expect_free(backend, sync_mode, k,
                                                 device),
        codec=codec or "fp32")


def _minibatch_program(model, backend, device, expect) -> Program:
    return _ops_program(
        f"minibatch/{model}-{backend}-fp32",
        functools.partial(_minibatch_ops, model, backend, device),
        {"entry": "minibatch", "model": model, "backend": backend},
        device, expect_scatter_free=expect)


def _ops_grid(device: torch.device) -> list:
    progs = [
        _fullbatch_program(model, backend, sync_mode, codec, device)
        for model in MODELS
        for backend in BACKENDS
        for sync_mode in SYNCS
        for codec in WIRE_CODECS
    ]
    # pallas backend: scatter-free by construction, the green cells
    # proving the no-scatter rule passes real programs (plus the k=1 hot
    # paths tests/test_aggregate.py pins in the reference)
    progs += [
        _fullbatch_program("gat", "pallas", "ring", "fp32", device),
        _fullbatch_program("sage", "pallas", "local", "fp32", device, k=1),
        _fullbatch_program("gat", "pallas", "local", "fp32", device, k=1),
        # anchor: the scatter oracle MUST trip the rule
        _fullbatch_program("gat", "scatter", "local", "fp32", device, k=1),
        _minibatch_program("gat", "pallas", device, True),
        _minibatch_program("gat", "scatter", device, False),
        _minibatch_program("sage", "tiled", device,
                           scatter_free_traced("tiled", device)),
    ]
    for model, backend, expect in (("sage", "pallas", True),
                                   ("gat", "scatter", False)):
        progs.append(_ops_program(
            f"serving/{model}-{backend}-fp32",
            functools.partial(_serving_ops, model, backend, device),
            {"entry": "serving", "model": model, "backend": backend},
            device, expect_scatter_free=expect))
    for model, backend, k in (("sage", "tiled", K), ("gat", "pallas", 1)):
        sync = "halo" if k > 1 else "local"
        progs.append(_ops_program(
            f"inference/{model}-{backend}-{sync}-k{k}",
            functools.partial(_inference_ops, model, backend, k, device),
            {"entry": "inference", "model": model, "backend": backend,
             "sync": sync, "k": k},
            device, expect_scatter_free=_expect_free(backend, sync, k,
                                                     device)))
    return progs


def _collectives_grid(device: torch.device) -> list:
    cells = [
        ("ring", "fp32"), ("ring", "int8"),
        ("halo", "fp32"), ("halo", "int8"),
        ("dense", "fp32"),
    ]
    progs = []
    for mode, codec in cells:
        make = (functools.partial(_ring_collectives, codec, device)
                if mode == "ring"
                else functools.partial(_partial_agg_collectives, mode, codec,
                                       device))
        progs.append(Program(
            name=f"hlo/{mode}-{codec}", kind="collectives", make=make,
            meta={"entry": "sync-aggregate", "sync": mode}, device=device,
            budget=functools.partial(_sync_budget, mode, codec, device),
            codec=codec,
        ))
    return progs


def _donation_programs(device: torch.device) -> list:
    # `donation/jit-probe` has no twin: there is no jit to donate to
    return [
        Program(
            name="donation/fullbatch-lossy", kind="donation", device=device,
            meta={"entry": "fullbatch"},
            make=functools.partial(_donation_fullbatch, "int8", device)),
        Program(
            name="donation/minibatch-lossless", kind="donation",
            device=device, meta={"entry": "minibatch"},
            make=functools.partial(_donation_minibatch, None, device)),
        Program(
            name="donation/minibatch-lossy", kind="donation", device=device,
            meta={"entry": "minibatch"},
            make=functools.partial(_donation_minibatch, "int8", device)),
    ]


def _retrace_programs(device: torch.device) -> list:
    # the port's only compile is a kernel build / library load
    # (kernels/_build.py): a warm sweep, new shapes and codec tiers
    # included, does none
    sweeps = (("fullbatch-fp32", _sweep_fullbatch_fp32,
               {"entry": "fullbatch", "steps": 3}),
              ("fullbatch-variable", _sweep_fullbatch_variable,
               {"entry": "fullbatch", "epochs": 4, "codec": "variable"}),
              ("minibatch-variable", _sweep_minibatch_variable,
               {"entry": "minibatch", "epochs": 4, "codec": "variable"}),
              ("serving", _sweep_serving,
               {"entry": "serving", "answers": 2}))
    return [Program(name=f"retrace/{name}", kind="retrace", device=device,
                    sweep=functools.partial(sweep, device), retrace_budget=0,
                    meta=meta)
            for name, sweep, meta in sweeps]


def build_programs(grid: str = "smoke", device="cuda") -> list:
    """The program set for a grid tier, on `device`.

    tiny   a fast cross-section (seconds): one green + one anchor ops cell
           per entry point, and the donation checks.
    smoke  the full gate: every ops grid cell, the five sync-aggregate
           collectives cells, the donation checks and the retrace sweeps.
    """
    if grid not in GRIDS:
        raise ValueError(f"unknown grid {grid!r}; choose from {GRIDS}")
    device = torch.device(device)
    if grid == "tiny":
        return [
            _fullbatch_program("sage", "pallas", "ring", "int8", device),
            _fullbatch_program("gat", "scatter", "local", "fp32", device,
                               k=1),
            _minibatch_program("gat", "pallas", device, True),
        ] + _donation_programs(device)
    return (_ops_grid(device) + _collectives_grid(device)
            + _donation_programs(device) + _retrace_programs(device))


# ---------------------------------------------------------------------------
# Seeded violations (--inject-violation): prove each rule can fail
# ---------------------------------------------------------------------------


def _scatter_violation(device: torch.device) -> list:
    from repro_torch.analysis.dispatch import record

    def bad(h):
        return torch.zeros(16, D, device=device).index_add_(
            0, torch.arange(8, device=device), h)

    return [record(bad, torch.zeros(8, D, device=device))]


def _dtype_violation(device: torch.device) -> list:
    from repro_torch.analysis.dispatch import record

    def bad(x):
        return x.to(torch.bfloat16).to(torch.float32)

    return [record(bad, torch.zeros(8, D, device=device))]


def _budget_violation() -> list:
    from repro_torch.obs.trace import CollectiveEvent

    # an all-reduce 512x its budget and an unbudgeted permute
    return [CollectiveEvent("all-reduce", 1024 * D * 4),
            CollectiveEvent("collective-permute", 64 * 4)]


def _donation_violation(device: torch.device):
    tr = _fresh_fullbatch(None, device)
    stash = []

    def step():
        stash.append(tr.params)      # keeps every step's params alive
        tr.train_step()

    return step, functools.partial(_carries, tr)


def _retrace_violation_sweep() -> None:
    from repro_torch.kernels import _build

    # a kernel specialised per shape: each new shape builds its own
    # library (noted as `CudaLibrary.build` notes one, so this runs
    # without nvcc)
    for n in (4, 8, 16):
        _build.BUILDS[(f"injected_scale_{n}", "build")] += 1


def violation_program(rule: str, device="cuda") -> Program:
    """A program deliberately violating `rule`: the CLI's
    --inject-violation hook, proving the gate exits non-zero."""
    device = torch.device(device)
    meta = {"injected": True}
    if rule == "no-scatter":
        return Program(
            name="injected/no-scatter", kind="ops", device=device, meta=meta,
            make=functools.partial(_scatter_violation, device),
            expect_scatter_free=True)
    if rule == "dtype-policy":
        return Program(
            name="injected/dtype-policy", kind="ops", device=device,
            meta=meta, make=functools.partial(_dtype_violation, device),
            codec="fp32")
    if rule == "collective-budget":
        return Program(
            name="injected/collective-budget", kind="collectives",
            device=device, meta=meta, make=_budget_violation,
            budget=lambda: {"all-reduce": {"count": (1, 1),
                                           "cluster_bytes": 64}})
    if rule == "donation":
        return Program(
            name="injected/donation", kind="donation", device=device,
            meta=meta, make=functools.partial(_donation_violation, device))
    if rule == "retrace-guard":
        return Program(
            name="injected/retrace-guard", kind="retrace", device=device,
            meta=meta, sweep=_retrace_violation_sweep, retrace_budget=1)
    raise ValueError(f"no seeded violation for rule {rule!r}")

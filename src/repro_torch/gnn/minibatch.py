"""DistDGL-style mini-batch distributed training (vertex partitioning).

Twin of repro/gnn/minibatch.py. Every worker owns one vertex partition
(graph, features, its training vertices). A training step is the paper's
five phases (§5.1): sampling and feature loading on the host
(gnn/pipeline.py, serial or overlapped with the device step), then the
forward, the backward and the update on the device. `mfg_forward` is also
serving's recompute (serve/engine.py).

Device side: `lay` is a dict of tensors (esrc, edst, emask, deg, and for the
tiled backends agg_order / agg_ldst); `n_dst` is static from the pad plan.
Aggregation targets are sized n_dst+1; index n_dst is the padding sink. Pad
edges' `esrc` must be clamped to the last source row, as JAX's gather
clamps (the pipeline and the serving engine do so when they stage a
batch); their messages are masked to zero.

The reference runs the k workers as `jax.vmap(..., axis_name="workers")`
over the stacked [k, ...] batch with a `psum` of each worker's (loss sum,
count). Here `minibatch_loss` runs `mfg_forward` once per worker over its
slice of the stacked tensors, sums the k pairs in worker order and divides
once; one autograd pass and one Adam update follow (`optim.adam_step`).
Under a lossy wire codec (core/wire.py) the step is the reference's
error-feedback one: worker w's forward runs on its own parameter copy,
its gradient is k * dL/dW_w (`models.per_partition_grads`), and the k
gradients are reduced through `codec_grad_reduce` with a [k, ...] EF
carry; the feature store ships its miss rows through the codec (fixed at
build: features are layer-0 data).

The step is repeatable bit for bit on the card (`repeatable_step`):
PyTorch's deterministic algorithms are switched on for it alone, which
sends the scatter backend's `index_add_` and the other accumulating
scatters to their sort-based, fixed-order implementations, under every
codec. A fault injector (fault/inject.py) reaches the batch pipeline's
seams through `build(injector=...)`; with `start_step` a resumed trainer
draws the batches an uninterrupted one would from that step on.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import time
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.deterministic

from repro_torch.core.graph import Graph
from repro_torch.core.partition_book import VertexPartitionBook, build_vertex_book
from repro_torch.core.wire import as_codec, codec_grad_reduce, ef_init
from repro_torch.gnn import models
from repro_torch.gnn.feature_store import FeatureStore
from repro_torch.gnn.models import GNNSpec
from repro_torch.gnn.pipeline import BatchPreparer, PipelineEngine
from repro_torch.gnn.sampling import PAPER_FANOUTS, SamplePlan
from repro_torch.kernels import ops
from repro_torch.obs.trace import get_tracer
from repro_torch.optim import (
    AdamState,
    adam_init,
    adam_step,
    adam_update,
    tree_map,
)

# cuBLAS's workspace setting that deterministic mode asks for (PyTorch
# checks the variable at each matmul). It is PyTorch's default workspace on
# Hopper (sm_90: 8 buffers of 4096 KiB), so setting it changes nothing there.
CUBLAS_WORKSPACE = ":4096:8"


def _mb_aggregate(messages, lay, n_dst: int, backend: str,
                  reduce: str = "sum"):
    """Reduce per-edge messages into the [n_dst+1, d] destination rows."""
    return ops.aggregate(
        messages, lay["edst"], n_dst + 1,
        edge_order=lay.get("agg_order"), local_dst=lay.get("agg_ldst"),
        backend=backend, reduce=reduce,
    )


def _mb_sage_layer(p, h_src, lay, n_dst: int, *, final: bool,
                   backend: str = "scatter"):
    msg = h_src[lay["esrc"]] * lay["emask"][:, None]
    agg = _mb_aggregate(msg, lay, n_dst, backend)
    mean = agg[:-1] / torch.clamp(lay["deg"][:-1], min=1.0)[:, None]
    h_self = h_src[:n_dst]
    out = h_self @ p["w_self"] + mean @ p["w_neigh"] + p["b"]
    return out if final else F.relu(out)


def _mb_gcn_layer(p, h_src, lay, n_dst: int, *, final: bool,
                  backend: str = "scatter"):
    deg_dst = lay["deg"][:-1] + 1.0
    msg = h_src[lay["esrc"]] * lay["emask"][:, None]
    agg = _mb_aggregate(msg, lay, n_dst, backend)
    h = (agg[:-1] + h_src[:n_dst]) / deg_dst[:, None]
    out = h @ p["w"] + p["b"]
    return out if final else F.relu(out)


def _mb_gat_layer(p, h_src, lay, n_dst: int, *, final: bool,
                  backend: str = "scatter"):
    heads, dh = p["a_src"].shape
    z = (h_src @ p["w"]).reshape(h_src.shape[0], heads, dh)
    s_src = torch.einsum("nhd,hd->nh", z, p["a_src"])
    s_dst = torch.einsum("nhd,hd->nh", z[:n_dst], p["a_dst"])
    s_dst_pad = F.pad(s_dst, (0, 0, 0, 1))
    e = F.leaky_relu(s_src[lay["esrc"]] + s_dst_pad[lay["edst"]], 0.2)
    e = torch.where(lay["emask"][:, None], e, -1e30)
    e_self = F.leaky_relu(s_src[:n_dst] + s_dst, 0.2)

    # softmax stabilisation max through the same segment reduce as the sums,
    # with no gradient (the reference's stop_gradient; exact, softmax is
    # shift-invariant)
    with torch.no_grad():
        m = _mb_aggregate(e, lay, n_dst, backend, reduce="max")
        m = torch.maximum(m[:-1], e_self)
    m_pad = F.pad(m, (0, 0, 0, 1))
    w = torch.exp(e - m_pad[lay["edst"]]) * lay["emask"][:, None]
    w_self = torch.exp(e_self - m)
    den = _mb_aggregate(w, lay, n_dst, backend)
    den = den[:-1] + w_self
    num = _mb_aggregate(
        (w[:, :, None] * z[lay["esrc"]]).reshape(-1, heads * dh),
        lay, n_dst, backend,
    ).reshape(n_dst + 1, heads, dh)
    num = num[:-1] + w_self[:, :, None] * z[:n_dst]
    out = (num / torch.clamp(den, min=1e-16)[:, :, None]).reshape(n_dst, heads * dh)
    out = (out + p["b"]) @ p["w_out"]
    return out if final else F.elu(out)


_MB_LAYERS = {"sage": _mb_sage_layer, "gcn": _mb_gcn_layer, "gat": _mb_gat_layer}


def mfg_forward(spec: GNNSpec, layer_params: Sequence, batch,
                layer_sizes: Sequence[int]) -> torch.Tensor:
    """Forward one padded MFG stack through `layer_params`, which may be a
    suffix of the model's layers (serving recomputes only the last `hops`
    layers, so `batch["x"]` is then embedding rows). The stack always ends
    at the model's final layer, so the last entry has no activation."""
    h = batch["x"]
    layer_fn = _MB_LAYERS[spec.model]
    L = len(layer_params)
    for li, p in enumerate(layer_params):
        h = layer_fn(p, h, batch["layers"][li], layer_sizes[li],
                     final=(li == L - 1), backend=spec.agg_backend)
    return h


def _worker_params(params, w: int):
    """Worker w's copy of per-worker parameters ([k, ...] leaves)."""
    return tree_map(lambda t: t[w], params)


def _worker_batch(stacked, w: int) -> dict:
    """Worker w's slice of a stacked [k, ...] batch tree (views)."""
    return {
        "x": stacked["x"][w],
        "seed_labels": stacked["seed_labels"][w],
        "seed_mask": stacked["seed_mask"][w],
        "layers": [{name: t[w] for name, t in lay.items()}
                   for lay in stacked["layers"]],
    }


def _loss_terms(spec: GNNSpec, params, batch,
                layer_sizes: Sequence[int]) -> torch.Tensor:
    """One worker's [masked -log p sum, count] over its padded MFG stack
    (what the reference's `minibatch_loss` psums over the workers)."""
    h = mfg_forward(spec, params["layers"], batch, layer_sizes)
    logits = h[: batch["seed_labels"].shape[0]]
    logp = F.log_softmax(logits, dim=-1)
    labels = torch.clamp(batch["seed_labels"].long(), min=0)
    picked = torch.gather(logp, -1, labels[:, None])[:, 0]
    w = (batch["seed_mask"] & (batch["seed_labels"] >= 0)).float()
    return torch.stack([-(picked * w).sum(), w.sum()])


def minibatch_loss(spec: GNNSpec, params, stacked,
                   layer_sizes: Sequence[int], *,
                   per_worker: bool = False) -> torch.Tensor:
    """The loss over a stacked [k, ...] batch: the workers' (sum, count)
    pairs summed in worker order, divided once. Every worker of the
    reference's vmap returns this same value (its psum) and the step takes
    their mean, so this scalar is the reference's step loss. With
    `per_worker`, every parameter leaf is [k, ...] and worker w's forward
    runs on copy w."""
    total = None
    for w in range(stacked["x"].shape[0]):
        wp = _worker_params(params, w) if per_worker else params
        terms = _loss_terms(spec, wp, _worker_batch(stacked, w),
                            layer_sizes)
        total = terms if total is None else total + terms
    return total[0] / torch.clamp(total[1], min=1.0)


@contextlib.contextmanager
def repeatable_step(on: bool = True):
    """Run the enclosed work with PyTorch's deterministic algorithms, then
    restore the process's setting.

    On the card `index_add_` (the scatter backend's sum) adds in atomic
    order, and so do the transposes of `index_select` / `gather`; under
    this mode they take sort-based implementations that add in a fixed
    order, and an operation with no such implementation raises instead of
    running. The mode is process-wide, so it is scoped to the step: serving
    and full-batch training keep theirs. Uninitialised memory is not
    filled meanwhile (the mode's default NaN fill costs a pass over every
    allocation and makes nothing repeatable that the step reads); it is
    switched off before the mode goes on and back after it goes off, so a
    concurrent allocation (the prefetch thread's) never sees the fill."""
    if not on:
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    was = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn_only)
        torch.utils.deterministic.fill_uninitialized_memory = fill


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StepMetrics:
    loss: float
    input_vertices: np.ndarray   # [k]
    remote_vertices: np.ndarray  # [k]
    edges: np.ndarray            # [k]
    sample_time_host: float      # seconds, wall (whole step, all workers)
    compute_time_host: float     # device step (serial: absorbs step overhead
    #                              so the four phases sum to step_wall_host)
    # feature-store phase accounting: remote = cache_hits + remote_misses
    cache_hits: np.ndarray = None      # [k]
    remote_misses: np.ndarray = None   # [k]
    miss_bytes: np.ndarray = None      # [k] logical (f32) miss bytes
    wire_bytes: np.ndarray = None      # [k] codec-encoded miss bytes
    # pipeline phase accounting (gnn/pipeline.py): host wall per phase, the
    # consumer-side step wall, and how much host time the prefetch hid
    fetch_time_host: float = 0.0       # feature gather + stack
    transfer_time_host: float = 0.0    # host -> device
    step_wall_host: float = 0.0        # next_batch + device step, consumer
    queue_wait_host: float = 0.0       # exposed (un-hidden) host time
    overlap: bool = False

    @property
    def host_time(self) -> float:
        """Host prep wall for this batch (sample + fetch + transfer)."""
        return self.sample_time_host + self.fetch_time_host + self.transfer_time_host

    @property
    def overlap_efficiency(self) -> float:
        """Hidden host time / total host time for this step: 0.0 in serial
        mode, -> 1.0 in overlap steady state when the queue always has a
        batch ready; 1.0 when there was no host work at all."""
        host = self.host_time
        if host <= 0.0:
            return 1.0
        return max(host - self.queue_wait_host, 0.0) / host

    @property
    def hit_rate(self) -> float:
        """Cache hits / remote feature requests, whole step: 1.0 when the
        step needed no remote vertices; 0.0 when hit accounting is absent
        but remote vertices exist."""
        remote = float(self.remote_vertices.sum())
        if not remote:
            return 1.0
        if self.cache_hits is None:
            return 0.0
        return float(self.cache_hits.sum()) / remote


@dataclasses.dataclass
class MiniBatchTrainer:
    graph: Graph
    book: VertexPartitionBook
    spec: GNNSpec
    features: np.ndarray
    labels: np.ndarray
    train_vertices_per_worker: list
    fanouts: tuple
    plan: SamplePlan
    global_batch: int
    device: torch.device
    params: Any = None
    opt_state: Optional[AdamState] = None
    seed: int = 0
    lr: float = 1e-3
    rebalance: bool = False
    store: Optional[FeatureStore] = None
    overlap: bool = False
    prefetch_depth: int = 2
    start_step: int = 0                # first global step to draw
    injector: Any = None               # fault.FaultInjector (None = no faults)
    repeatable: bool = True            # the step under `repeatable_step`
    codec: Any = None                  # wire codec name/instance (None=fp32)
    ef_state: Any = None               # error-feedback carry (lossy codecs)
    _load_ema: Optional[np.ndarray] = None
    _seed_share: Optional[np.ndarray] = None

    @classmethod
    def build(
        cls,
        graph: Graph,
        vertex_assignment: np.ndarray,
        k: int,
        spec: GNNSpec,
        features: np.ndarray,
        labels: np.ndarray,
        train_mask: np.ndarray,
        *,
        device: torch.device,
        global_batch: int = 1024,
        fanouts: Optional[Sequence[int]] = None,
        seed: int = 0,
        lr: float = 1e-3,
        rebalance: bool = False,
        cache_policy: str = "none",
        cache_budget: int = 0,
        overlap: bool = False,
        prefetch_depth: int = 2,
        codec=None,
        start_step: int = 0,
        injector=None,
        repeatable: bool = True,
    ) -> "MiniBatchTrainer":
        book = build_vertex_book(graph, vertex_assignment, k)
        fanouts = tuple(fanouts or PAPER_FANOUTS[spec.num_layers])
        train_ids = np.where(train_mask)[0]
        per_worker = [train_ids[book.owner[train_ids] == w] for w in range(k)]
        seeds_per_worker = max(global_batch // k, 1)
        plan = SamplePlan.build(seeds_per_worker, fanouts)
        params = models.init_params(spec, seed=seed, device=device)
        features = features.astype(np.float32)
        store = FeatureStore.build(
            graph, book, policy=cache_policy, budget=cache_budget,
            features=features, seed=seed, codec=codec,
        )
        return cls(
            graph=graph, book=book, spec=spec,
            features=features, labels=labels.astype(np.int32),
            train_vertices_per_worker=per_worker, fanouts=fanouts, plan=plan,
            global_batch=global_batch, device=torch.device(device),
            params=params, opt_state=adam_init(params), seed=seed,
            lr=lr, rebalance=rebalance, store=store,
            overlap=overlap, prefetch_depth=prefetch_depth,
            start_step=start_step, injector=injector, repeatable=repeatable,
            codec=codec,
            _load_ema=np.ones(k), _seed_share=np.full(k, 1.0 / k),
        )

    # ------------------------------------------------------------- pipeline
    @functools.cached_property
    def engine(self) -> PipelineEngine:
        """The step execution engine (gnn/pipeline.py). Serial mode costs no
        threads; overlap mode starts the producer on first use."""
        preparer = BatchPreparer(
            graph=self.graph, book=self.book, store=self.store,
            plan=self.plan, fanouts=self.fanouts, labels=self.labels,
            train_pools=self.train_vertices_per_worker,
            global_batch=self.global_batch, tiled_layout=self._tiled_layout,
            device=self.device, seed=self.seed, injector=self.injector,
            start_step=self.start_step,
        )
        engine = PipelineEngine(
            preparer, overlap=self.overlap, prefetch_depth=self.prefetch_depth)
        if self.rebalance:
            engine.set_seed_share(self._seed_share)
        return engine

    def close(self) -> None:
        """Release the engine's producer/sampler threads (overlap mode)."""
        if "engine" in self.__dict__:
            self.engine.close()

    @property
    def _tiled_layout(self) -> bool:
        return self.spec.agg_backend != "scatter"

    @property
    def _layer_sizes(self) -> list:
        return [p.n_dst for p in self.plan.layers]

    # ------------------------------------------------------------------ step
    def _init_ef(self):
        """Per-worker zero EF residuals, stacked [k, ...]."""
        k = self.book.k
        return ef_init(tree_map(lambda p: p.expand((k,) + p.shape),
                                self.params))

    def set_epoch(self, epoch: int) -> None:
        """Advance an epoch-scheduled codec (VariableRatioCodec) on the
        gradient reduce. The feature store's codec is fixed at build time:
        features are layer-0 data, so the schedule's layer-0 tier applies
        to them throughout."""
        advance = getattr(as_codec(self.codec), "at_epoch", None)
        if advance is not None:
            self.codec = advance(epoch)

    def device_step(self, stacked) -> float:
        """One Adam step on a stacked device batch; returns the loss before
        the update. Reading it waits for the whole step, update included
        (one stream)."""
        sizes = self._layer_sizes
        codec = as_codec(self.codec)
        with repeatable_step(self.repeatable):
            if codec.lossless:
                loss, self.params, self.opt_state = adam_step(
                    lambda params: minibatch_loss(self.spec, params, stacked,
                                                  sizes),
                    self.params, self.opt_state, lr=self.lr)
                return float(loss)
            if self.ef_state is None:
                self.ef_state = self._init_ef()
            loss, grads = models.per_partition_grads(
                lambda params: minibatch_loss(self.spec, params, stacked,
                                              sizes, per_worker=True),
                self.params, k=self.book.k, stacked=True)
            mean, self.ef_state = codec_grad_reduce(
                codec, grads, self.ef_state, stacked=True)
            self.params, self.opt_state = adam_update(
                mean, self.opt_state, self.params, lr=self.lr)
            return float(loss)

    def train_step(self) -> StepMetrics:
        t0 = time.perf_counter()
        pb, wait = self.engine.next_batch()
        t1 = time.perf_counter()
        loss = self.device_step(pb.stacked)
        t2 = time.perf_counter()
        wall = t2 - t0
        # serial mode: phases are contiguous, so charge the (tiny) engine
        # overhead to compute and the four phases sum exactly to the wall
        compute = (t2 - t1) if self.overlap else (wall - pb.host_time)
        tracer = get_tracer()
        if tracer.enabled:
            # the step/compute spans share the StepMetrics timestamps —
            # one clock, whether read from the trace or from the row; both
            # end after `device_step` read the loss back from the device
            tracer.record_span("minibatch.compute", t1, t2, cat="step",
                               args={"step": pb.index})
            tracer.record_span("minibatch.step", t0, t2, cat="step",
                               args={"step": pb.index, "loss": loss})

        if self.rebalance:
            self._load_ema = (0.7 * self._load_ema
                              + 0.3 * np.maximum(pb.input_vertices, 1))
            inv = 1.0 / self._load_ema
            self._seed_share = inv / inv.sum()
            self.engine.set_seed_share(self._seed_share)

        fetch = pb.fetch_stats
        return StepMetrics(
            loss=loss,
            input_vertices=pb.input_vertices,
            remote_vertices=pb.remote_vertices,
            edges=pb.edges,
            sample_time_host=pb.sample_time,
            compute_time_host=compute,
            cache_hits=np.array([s.num_cache_hit for s in fetch]),
            remote_misses=np.array([s.num_remote_miss for s in fetch]),
            miss_bytes=np.array([s.miss_bytes for s in fetch]),
            wire_bytes=np.array([s.wire_bytes for s in fetch]),
            fetch_time_host=pb.fetch_time,
            transfer_time_host=pb.transfer_time,
            step_wall_host=wall,
            queue_wait_host=wait,
            overlap=self.overlap,
        )

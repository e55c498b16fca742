"""Overlapped mini-batch execution: sampling and feature prefetch pipelined
against the device step.

Twin of repro/gnn/pipeline.py, tracer calls included. Per mini-batch:

  draw      per-worker seed draw            (host, per-step RNG streams)
  sample    k workers' k-hop MFGs           (host thread pool, parallel)
  fetch     feature-store gather + stack    (host; the store is read-only)
  transfer  host -> device of the batch     (copy stream, waited for)
  compute   the train step                  (device)

Two modes behind one `PipelineEngine.next_batch()`:

  serial  (overlap=False)  draw..transfer inline on the caller's thread —
          the correctness oracle, whose contiguous phase clock makes
          sample + fetch + transfer + compute == the step wall.
  overlap (overlap=True)   draw..transfer on a producer thread, up to
          `prefetch_depth` batches ahead through a bounded queue, while the
          consumer runs the device step.

Determinism: batch t is a pure function of (seed, t), never of the thread
schedule. One `np.random.SeedSequence(seed)` spawns a child per step, which
spawns one grandchild per worker; worker w's seed draw and its sampling for
step t both use that (t, w) generator. Both modes therefore give the same
batches bit for bit, and the same batches as the reference's preparer.

Fault seams (fault/inject.py), one `None` check each when no injector is
set: `prepare` calls `at_step(t)` (a `crash` raises `WorkerCrash`); each
worker's draw + sample calls `on_sample(t, w)` and its gather `on_fetch(t,
w)`, both under `retry_call`, and a retried attempt rebuilds its generator
from the same (t, w) `SeedSequence`, so it is bit for bit the first. An
injected fault raised on the producer thread reaches the consumer as
itself, as serial mode raises it inline.

Under an installed tracer (obs/trace.py) `prepare` records the
`pipeline.sample` / `fetch` / `transfer` spans (its `PhaseClock`: the
spans are the `PreparedBatch` times), and the overlapped engine the
consumer's `pipeline.queue_wait` span and the `pipeline.queue_depth`
gauge (producer and consumer side).

The transfer on the card: the stacked host arrays are written into
page-locked memory during the fetch and copied with `non_blocking=True` on
the preparer's own CUDA stream, which the preparer then waits for, so
`transfer_time` is the copy itself. The consumer's stream waits on the
copy's event and every transferred tensor is recorded for that stream
(`PreparedBatch.claim`), so the caching allocator cannot hand the memory to
the next copy while the step may still read it. Pad edges' `esrc` (==
n_src) is clamped to the last source row on the device, as JAX's gather
clamps; `PreparedBatch.host` keeps the arrays as the sampler made them.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.partition_book import VertexPartitionBook
from repro_torch.fault.inject import FaultInjector, InjectedFault, retry_call
from repro_torch.gnn.feature_store import FeatureStore, FetchStats
from repro_torch.gnn.sampling import SamplePlan, SampledBatch, sample_blocks
from repro_torch.obs.trace import get_tracer

__all__ = ["BatchPreparer", "PipelineEngine", "PreparedBatch"]

# integer index arrays the device step reads as int64 (as serve/engine.py
# stages them); they cross the bus at the sampler's int32
_INDEX_KEYS = ("esrc", "edst", "agg_order")


@dataclasses.dataclass
class PreparedBatch:
    """One global mini-batch, host work done, resident on the device."""

    index: int                     # step number this batch was drawn for
    stacked: dict                  # device tensors read by the train step
    host: dict                     # the stacked host arrays, as sampled
    fetch_stats: "list[FetchStats]"  # per worker
    input_vertices: np.ndarray     # [k]
    remote_vertices: np.ndarray    # [k]
    edges: np.ndarray              # [k]
    sample_time: float             # host wall seconds (draw + sample)
    fetch_time: float              # host wall seconds (gather + stack)
    transfer_time: float           # host wall seconds (copy, waited for)
    ready: Optional[torch.cuda.Event] = None  # the copy's end (CUDA only)

    @property
    def host_time(self) -> float:
        return self.sample_time + self.fetch_time + self.transfer_time

    def tensors(self) -> list:
        out = [self.stacked["x"], self.stacked["seed_labels"],
               self.stacked["seed_mask"]]
        for lay in self.stacked["layers"]:
            out += list(lay.values())
        return out

    def claim(self) -> None:
        """Hand the batch to the calling thread's current stream: that
        stream waits for the copy, and each tensor is recorded for it, so
        its memory is not reused before the work queued there has read it."""
        if self.ready is None:
            return
        stream = torch.cuda.current_stream(self.stacked["x"].device)
        stream.wait_event(self.ready)
        for t in self.tensors():
            t.record_stream(stream)


class BatchPreparer:
    """Host side of the pipeline: produces `PreparedBatch` t from (seed, t).

    Owns the deterministic RNG tree and the draw/sample/fetch/transfer
    recipe; knows nothing about threads — `prepare()` is called either
    inline (serial mode) or from the engine's producer thread (overlap
    mode), optionally fanning the per-worker sampling out on an executor.
    """

    def __init__(
        self,
        *,
        graph: Graph,
        book: VertexPartitionBook,
        store: FeatureStore,
        plan: SamplePlan,
        fanouts: "tuple[int, ...]",
        labels: np.ndarray,
        train_pools: "list[np.ndarray]",
        global_batch: int,
        tiled_layout: bool,
        device: torch.device,
        seed: int = 0,
        injector: Optional[FaultInjector] = None,
        start_step: int = 0,
        retry_attempts: int = 3,
        retry_timeout: float = 5.0,
    ) -> None:
        self.graph = graph
        self.book = book
        self.store = store
        self.plan = plan
        self.fanouts = fanouts
        self.labels = labels
        self.train_pools = train_pools
        self.global_batch = global_batch
        self.tiled_layout = tiled_layout
        self.injector = injector
        self.retry_attempts = retry_attempts
        self.retry_timeout = retry_timeout
        if injector is not None and injector.k is None:
            injector.k = len(train_pools)
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(self.device) if self._cuda
                             else None)
        self._root_ss = np.random.SeedSequence(seed)
        # Resume fast-forward: `spawn` is stateful (spawn-key counter), so
        # spawning `start_step` children at once and discarding them leaves
        # the tree exactly where a fresh preparer stands after `start_step`
        # prepare() calls — batch t is bitwise (seed, t) either way.
        if start_step > 0:
            self._root_ss.spawn(start_step)
        self._next_index = start_step
        # Force the lazily-built CSR now, on one thread, so parallel
        # per-worker sampling never races its construction.
        graph.csr()

    # ------------------------------------------------------------------ rng
    def _step_seed_seqs(self) -> "list[np.random.SeedSequence]":
        """One independent `SeedSequence` per worker for the next step.

        `spawn` is stateful, so step children MUST be spawned in step order
        — `prepare()` is the only caller and runs on one control thread per
        engine. The worker grandchildren make batch t worker w a pure
        function of (seed, t, w), independent of the sampling threads, and
        a retried (t, w) phase rebuilds its generator from the same
        sequence, so the retried batch is bit for bit the first attempt."""
        (step_ss,) = self._root_ss.spawn(1)
        return list(step_ss.spawn(len(self.train_pools)))

    def _seed_counts(self, seed_share: Optional[np.ndarray]) -> np.ndarray:
        k = self.book.k
        shares = np.full(k, 1.0 / k) if seed_share is None else seed_share
        counts = np.maximum((shares * self.global_batch).astype(int), 1)
        return np.minimum(counts, self.plan.seeds)

    # ------------------------------------------------------------- sampling
    def _draw_and_sample(self, index: int, w: int,
                         ss: np.random.SeedSequence,
                         count: int) -> SampledBatch:
        """Worker w's draw + k-hop sampling for step `index`, one attempt;
        everything random derives from `ss` inside this call, so a retry
        gets the identical batch."""
        gen = np.random.default_rng(ss)
        if self.injector is not None:
            self.injector.on_sample(index, w)
        pool = self.train_pools[w]
        if pool.shape[0] == 0:
            seeds = np.zeros(0, np.int64)
        else:
            n = min(int(count), pool.shape[0])
            seeds = gen.choice(pool, size=n, replace=False).astype(np.int64)
        return sample_blocks(
            self.graph, seeds, self.fanouts, self.plan, gen,
            self.labels, owner=self.book.owner, worker=w,
            tiled_layout=self.tiled_layout,
        )

    def _sample_job(self, index: int, w: int, ss: np.random.SeedSequence,
                    count: int) -> SampledBatch:
        return retry_call(
            lambda: self._draw_and_sample(index, w, ss, count),
            phase="sample", attempts=self.retry_attempts,
            timeout=self.retry_timeout)

    # ------------------------------------------------------------- stacking
    def _host_empty(self, shape: tuple, dtype) -> np.ndarray:
        """An uninitialised host array; page-locked when the batch goes to
        the card, so the copy reads it without staging."""
        tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
        return torch.empty(shape, dtype=tdtype, pin_memory=self._cuda).numpy()

    def _stack(self, arrays: list) -> np.ndarray:
        out = self._host_empty((len(arrays),) + arrays[0].shape,
                               arrays[0].dtype)
        for w, a in enumerate(arrays):
            out[w] = a
        return out

    def _gather_worker(self, index: int, w: int, ids: np.ndarray):
        if self.injector is not None:
            self.injector.on_fetch(index, w)
        return self.store.gather(w, ids)

    def _stack_batches(self, index: int, batches: "list[SampledBatch]"):
        """The feature-loading phase: every worker pulls its input vertices
        through the feature store ({shard, cache, remote} split), written
        straight into the stacked [k, ...] host layout."""
        n_in = batches[0].input_ids.shape[0]
        x = self._host_empty((len(batches), n_in, self.store.row_dim),
                             self.store.rows.dtype)
        fetch: "list[FetchStats]" = []
        for w, b in enumerate(batches):
            valid = b.input_mask
            x[w][~valid] = 0
            ids = b.input_ids[valid]
            x[w][valid], st = retry_call(
                lambda w=w, ids=ids: self._gather_worker(index, w, ids),
                phase="fetch", attempts=self.retry_attempts,
                timeout=self.retry_timeout)
            fetch.append(st)
        stacked = {
            "x": x,
            "seed_labels": self._stack([b.seed_labels for b in batches]),
            "seed_mask": self._stack([b.seed_mask for b in batches]),
            "layers": [
                {
                    "esrc": self._stack([b.layers[li].esrc for b in batches]),
                    "edst": self._stack([b.layers[li].edst for b in batches]),
                    "emask": self._stack([b.layers[li].emask
                                          for b in batches]),
                    "deg": self._stack([b.layers[li].sampled_deg
                                        for b in batches]),
                }
                for li in range(len(self.fanouts))
            ],
        }
        if self.tiled_layout:  # only stacked/transferred when a backend reads it
            for li, lay in enumerate(stacked["layers"]):
                lay["agg_order"] = self._stack(
                    [b.layers[li].agg_order for b in batches])
                lay["agg_ldst"] = self._stack(
                    [b.layers[li].agg_ldst for b in batches])
        return stacked, fetch

    # ------------------------------------------------------------- transfer
    def _to_device(self, host: dict) -> dict:
        """The device tree of `host`, the index arrays as int64 and pad
        `esrc` clamped to the layer's last source row."""
        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device, non_blocking=True)

        layers = []
        for pad, lay in zip(self.plan.layers, host["layers"]):
            d = {}
            for name, a in lay.items():
                t = put(a)
                if name in _INDEX_KEYS:
                    t = t.long()
                if name == "esrc":
                    t = torch.clamp(t, max=pad.n_src - 1)
                d[name] = t
            layers.append(d)
        return {"x": put(host["x"]), "seed_labels": put(host["seed_labels"]),
                "seed_mask": put(host["seed_mask"]), "layers": layers}

    def _transfer(self, host: dict):
        """(device tree, the copy's end event). On the card the copies run
        on the preparer's stream and are waited for here."""
        if not self._cuda:
            return self._to_device(host), None
        with torch.cuda.stream(self._copy_stream):
            stacked = self._to_device(host)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        ready.synchronize()
        return stacked, ready

    # -------------------------------------------------------------- prepare
    def prepare(
        self,
        seed_share: Optional[np.ndarray] = None,
        executor: Optional[ThreadPoolExecutor] = None,
    ) -> PreparedBatch:
        """Produce the next batch: draw + sample (parallel over workers when
        an executor is given), gather + stack, transfer. The tracer's
        `PhaseClock` keeps the phase spans contiguous (each boundary is ONE
        clock reading), so the three host times sum to the host wall and
        the recorded spans ARE the `PreparedBatch` durations. The transfer
        span ends after the copy's event is waited on."""
        index = self._next_index
        self._next_index += 1
        if self.injector is not None:
            self.injector.at_step(index)
        clock = get_tracer().phase_clock(cat="pipeline",
                                         args={"step": index})
        seqs = self._step_seed_seqs()
        counts = self._seed_counts(seed_share)
        jobs = [(index, w, ss, int(counts[w])) for w, ss in enumerate(seqs)]
        if executor is not None:
            batches = list(executor.map(
                lambda job: self._sample_job(*job), jobs))
        else:
            batches = [self._sample_job(*job) for job in jobs]
        sample_time = clock.split("pipeline.sample")
        host, fetch = self._stack_batches(index, batches)
        fetch_time = clock.split("pipeline.fetch")
        stacked, ready = self._transfer(host)
        transfer_time = clock.split("pipeline.transfer")
        return PreparedBatch(
            index=index,
            stacked=stacked,
            host=host,
            fetch_stats=fetch,
            input_vertices=np.array([b.num_input for b in batches]),
            remote_vertices=np.array([b.num_remote for b in batches]),
            edges=np.array([b.num_edges for b in batches]),
            sample_time=sample_time,
            fetch_time=fetch_time,
            transfer_time=transfer_time,
            ready=ready,
        )


class _Poison:
    """Producer -> consumer shutdown/error token."""

    def __init__(self, error: Optional[BaseException] = None) -> None:
        self.error = error


class PipelineEngine:
    """Bounded prefetch of `PreparedBatch`es against the device step.

    serial mode: `next_batch()` runs the preparer inline — no threads.
    overlap mode: a producer thread keeps a `prefetch_depth`-deep queue full
    (sampling fanned out on a worker thread pool), and `next_batch()` pops,
    reporting how long it had to wait — the exposed host time of that step.
    """

    def __init__(
        self,
        preparer: BatchPreparer,
        *,
        overlap: bool = False,
        prefetch_depth: int = 2,
    ) -> None:
        if prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        self.preparer = preparer
        self.overlap = overlap
        self.prefetch_depth = prefetch_depth
        self._share: Optional[np.ndarray] = None
        self._share_lock = threading.Lock()
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._queue: Optional[queue.Queue] = None
        self._pool: Optional[ThreadPoolExecutor] = None
        self._producer: Optional[threading.Thread] = None
        if overlap:
            k = len(preparer.train_pools)
            self._pool = ThreadPoolExecutor(
                max_workers=min(k, 8), thread_name_prefix="mb-sample")
            self._queue = queue.Queue(maxsize=prefetch_depth)
            self._producer = threading.Thread(
                target=self._produce, name="mb-prefetch", daemon=True)
            self._producer.start()

    # ---------------------------------------------------------- share knob
    def set_seed_share(self, share: Optional[np.ndarray]) -> None:
        """Publish a new seed-share vector (dynamic re-balancing). Applied
        to the next batch *drawn* — in overlap mode that is up to
        `prefetch_depth` batches in the future (delayed feedback)."""
        with self._share_lock:
            self._share = None if share is None else np.asarray(share).copy()

    def _current_share(self) -> Optional[np.ndarray]:
        with self._share_lock:
            return self._share

    # ------------------------------------------------------------ producer
    def _produce(self) -> None:
        tracer = get_tracer()
        try:
            while not self._stop.is_set():
                pb = self.preparer.prepare(self._current_share(), self._pool)
                while not self._stop.is_set():
                    try:
                        self._queue.put(pb, timeout=0.05)
                        # prefetch-queue occupancy, sampled from the
                        # producer side after each successful put
                        tracer.gauge("pipeline.queue_depth",
                                     self._queue.qsize())
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surface in the consumer, don't die mute
            self._error = e  # next_batch's liveness check reads this even
            #                  if the poison token below is never delivered
            while not self._stop.is_set():
                try:
                    self._queue.put(_Poison(e), timeout=0.05)
                    break
                except queue.Full:
                    continue

    # ------------------------------------------------------------ consumer
    def next_batch(self) -> "tuple[PreparedBatch, float]":
        """Return (batch, queue_wait_seconds), the batch claimed for the
        calling thread's stream. Serial mode prepares inline and reports
        the full host time as the wait (nothing is hidden)."""
        if self._stop.is_set():  # same lifecycle semantics in both modes
            raise RuntimeError("pipeline engine is closed")
        if not self.overlap:
            pb = self.preparer.prepare(self._current_share(), None)
            pb.claim()
            return pb, pb.host_time
        t0 = time.perf_counter()
        while True:
            if self._stop.is_set():
                raise RuntimeError("pipeline engine is closed")
            try:
                item = self._queue.get(timeout=0.1)
                break
            except queue.Empty:
                # never block forever on a producer that can no longer put
                if self._producer is not None and not self._producer.is_alive():
                    err = self._error
                    self.close()
                    raise RuntimeError("pipeline producer died") from err
        t1 = time.perf_counter()
        wait = t1 - t0
        tracer = get_tracer()
        if tracer.enabled:
            tracer.record_span("pipeline.queue_wait", t0, t1, cat="pipeline")
            tracer.gauge("pipeline.queue_depth", self._queue.qsize())
        if isinstance(item, _Poison):
            self.close()
            if isinstance(item.error, InjectedFault):
                # an injected fault keeps its type across the producer
                # boundary, so the caller's recovery (crash -> resume) sees
                # what serial mode raises inline
                raise item.error
            if item.error is not None:
                raise RuntimeError("pipeline producer failed") from item.error
            raise RuntimeError("pipeline closed")
        item.claim()
        return item, wait

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Stop the producer and release its threads (idempotent)."""
        self._stop.set()
        if self._queue is not None:
            while True:  # unblock a producer stuck on a full queue
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
        if self._producer is not None and self._producer.is_alive():
            self._producer.join(timeout=5.0)
        if self._pool is not None:
            self._pool.shutdown(wait=False)

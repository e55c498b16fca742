"""The serving engine: embedding store + final-layer recompute, simulated QPS.

Twin of repro/serve/engine.py. A request for
vertex v's prediction is answered in three phases, priced on the paper's
cluster by `core.cost_model.serve_request`:

  1. sample    — a `hops`-deep MFG rooted at the micro-batch's targets
                 (host, serve/batcher.py; static `LayerPad` shapes)
  2. fetch     — the MFG's input frontier reads layer-(L-hops) embedding
                 rows from the `RowStore`; only miss bytes cross the network
  3. recompute — the last `hops` layers run over the MFG on the device
                 (`minibatch.mfg_forward`, through `ops.aggregate`)

`run_serving_sim` drives Poisson arrivals through per-worker queues; every
worker serves its micro-batches serially at the cost model's service time.
Latencies are modeled for the paper's cluster; the host compute time is
measured on the device the engine runs on. A fault plan's `worker-death`
kills one worker at a virtual time; its unanswered requests fail over to
the survivors (fault/recovery.py `failover_assignment`) and every request
is still answered. Under an installed tracer (obs/trace.py) `answer`
records the `serve.gather` and `serve.compute` spans (the compute span's
duration is the measured host compute seconds, ended by the device
synchronise) and the sim records each request's lifecycle on its virtual
clock (`serve.queue`, `serve.service.*`), the `fault.rerouted` counter and
the `serve.worker_death` span.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.core.cost_model import PAPER_CLUSTER, ClusterSpec
from repro_torch.gnn.feature_store import FetchStats, RowStore
from repro_torch.gnn.inference import build_embedding_stores
from repro_torch.gnn.minibatch import mfg_forward
from repro_torch.gnn.models import GNNSpec
from repro_torch.gnn.sampling import SampledBatch, SamplePlan
from repro_torch.obs.trace import get_tracer
from repro_torch.serve.batcher import MicroBatch, MicroBatcher

__all__ = ["ServeEngine", "ServingReport", "build_serving", "run_serving_sim"]


@dataclasses.dataclass
class ServeEngine:
    """Per-worker online engine: store reads + last-layers recompute."""

    spec: GNNSpec
    params: Any                   # full model params (suffix sliced per step)
    store: RowStore               # layer-(L-hops) embedding rows
    plan: SamplePlan
    hops: int
    worker: int
    device: torch.device

    def __post_init__(self) -> None:
        if not 1 <= self.hops <= self.spec.num_layers:
            raise ValueError(
                f"hops={self.hops} outside [1, {self.spec.num_layers}]")
        expect = (self.spec.feature_dim if self.hops == self.spec.num_layers
                  else self.spec.hidden_dim)
        if self.store.row_dim != expect:
            raise ValueError(
                f"store row_dim {self.store.row_dim} != layer-"
                f"{self.spec.num_layers - self.hops} width {expect}")

    @property
    def _layer_params(self) -> tuple:
        return tuple(self.params["layers"][self.spec.num_layers - self.hops:])

    @property
    def _sizes(self) -> tuple:
        return tuple(p.n_dst for p in self.plan.layers)

    def device_batch(self, batch: SampledBatch, x: np.ndarray) -> dict:
        """Stage one padded MFG + input rows onto the device. Pad edges'
        `esrc` (== n_src) is clamped to the last source row, as JAX's
        gather clamps; their messages are masked to zero."""
        dev = self.device
        layers = []
        for pad, lay in zip(self.plan.layers, batch.layers):
            d = {
                "esrc": torch.as_tensor(
                    np.minimum(lay.esrc, pad.n_src - 1), dtype=torch.int64,
                    device=dev),
                "edst": torch.as_tensor(lay.edst, dtype=torch.int64,
                                        device=dev),
                "emask": torch.as_tensor(lay.emask, device=dev),
                "deg": torch.as_tensor(lay.sampled_deg, device=dev),
            }
            if lay.agg_order is not None:
                d["agg_order"] = torch.as_tensor(lay.agg_order,
                                                 dtype=torch.int64, device=dev)
                d["agg_ldst"] = torch.as_tensor(lay.agg_ldst, device=dev)
            layers.append(d)
        return {"x": torch.as_tensor(x, device=dev), "layers": layers}

    @torch.inference_mode()
    def answer(
        self, batch: SampledBatch
    ) -> tuple[np.ndarray, FetchStats, float]:
        """Serve one padded micro-batch MFG.

        Returns (logits [plan.seeds, C] — rows past the true request count
        are padding, mask with batch.seed_mask —, the embedding-store fetch
        accounting, and the measured host compute seconds: the forward,
        ended by a device synchronise)."""
        tracer = get_tracer()
        ids = batch.input_ids[batch.input_mask]
        with (tracer.span("serve.gather", cat="serve",
                          args={"worker": self.worker})
              if tracer.enabled else contextlib.nullcontext()):
            rows, stats = self.store.gather(self.worker, ids)
        x = np.zeros((batch.input_ids.shape[0], self.store.row_dim),
                     dtype=np.float32)
        x[batch.input_mask] = rows
        dev = self.device_batch(batch, x)
        # host compute = the compute span's duration (the same two clock
        # readings either way)
        with tracer.span("serve.compute", cat="serve",
                         args={"worker": self.worker}) as sp:
            out = mfg_forward(self.spec, self._layer_params, dev, self._sizes)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        host_s = sp.duration
        return out[: self.plan.seeds].cpu().numpy(), stats, host_s

    def estimate(self, batch: SampledBatch,
                 stats: FetchStats,
                 cluster: ClusterSpec = PAPER_CLUSTER):
        """Cluster-model service time of one answered micro-batch, priced
        with the embedding store's wire codec."""
        return cost_model.serve_request(
            stats.num_input, stats.num_remote, stats.num_remote_miss,
            batch.num_edges, self.spec,
            embed_dim=self.store.row_dim, hops=self.hops, cluster=cluster,
            codec=self.store.codec,
        )


# ---------------------------------------------------------------------------
# QPS simulation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingReport:
    """Outcome of one simulated serving run (all workers)."""

    k: int
    offered_qps: float
    latency: np.ndarray        # [n] modeled per-request latency (seconds)
    latency_worker: np.ndarray  # [n] worker that served each request
    host_time: np.ndarray      # [b] measured host compute per batch
    service_time: np.ndarray   # [b] modeled service time per batch
    batch_size: np.ndarray     # [b]
    batch_worker: np.ndarray   # [b]
    fetch: FetchStats          # merged over every batch
    duration: float            # arrival-window length (seconds)
    queue_wait: Optional[np.ndarray] = None   # [n] dispatch - arrival
    batch_miss: Optional[np.ndarray] = None   # [b]
    # the answers, in the order of `latency`: the request's target vertex
    # and its served logits
    served_ids: Optional[np.ndarray] = None   # [n]
    logits: Optional[np.ndarray] = None       # [n, C]
    # fault-injection outcome (worker-death): every request is still
    # answered; the rerouted ones pay the detection delay + a colder store
    arrival: Optional[np.ndarray] = None      # [n] original arrival times
    fault_time: Optional[float] = None        # virtual death time tau
    dead_worker: int = -1
    rerouted: int = 0                         # requests failed over
    transition_end: Optional[float] = None    # last rerouted completion

    # -------------------------------------------------------------- metrics
    def _lat(self, worker: Optional[int]) -> np.ndarray:
        if worker is None:
            return self.latency
        return self.latency[self.latency_worker == worker]

    def p50(self, worker: Optional[int] = None) -> float:
        return float(np.percentile(self._lat(worker), 50))

    def p99(self, worker: Optional[int] = None) -> float:
        return float(np.percentile(self._lat(worker), 99))

    def sustainable_qps(self, worker: Optional[int] = None) -> float:
        """Throughput cap if the worker(s) were never idle: served requests
        per second of busy (service) time; the cluster cap (worker=None) is
        the sum of per-worker rates."""
        if worker is None:
            rates = [self.sustainable_qps(w) for w in range(self.k)]
            finite = [r for r in rates if np.isfinite(r)]
            return float(sum(finite)) if finite else float("inf")
        sel = self.batch_worker == worker
        busy = float(self.service_time[sel].sum())
        served = float(self.batch_size[sel].sum())
        return served / busy if busy > 0 else float("inf")

    def served(self, worker: Optional[int] = None) -> int:
        return int(self._lat(worker).shape[0])

    def worker_rows(self) -> list:
        return [
            {
                "worker": w,
                "served": self.served(w),
                "p50": self.p50(w) if self.served(w) else float("nan"),
                "p99": self.p99(w) if self.served(w) else float("nan"),
                "qps_sustainable": self.sustainable_qps(w),
            }
            for w in range(self.k)
        ]

    def transition_stats(self) -> Optional[dict]:
        """Latency of the degraded window: requests COMPLETING between the
        death (tau) and the last rerouted request's completion. None when no
        fault was injected."""
        if self.fault_time is None:
            return None
        done = self.arrival + self.latency
        win = (done >= self.fault_time) & (done <= self.transition_end)
        lat = self.latency[win]
        return {
            "fault_time": float(self.fault_time),
            "transition_end": float(self.transition_end),
            "window": float(self.transition_end - self.fault_time),
            "requests": int(win.sum()),
            "rerouted": int(self.rerouted),
            "p50": float(np.percentile(lat, 50)) if lat.size else float("nan"),
            "p99": float(np.percentile(lat, 99)) if lat.size else float("nan"),
        }


def run_serving_sim(
    engines: list,
    batchers: list,
    owner: np.ndarray,
    request_ids: np.ndarray,
    arrivals: np.ndarray,
    *,
    cluster: ClusterSpec = PAPER_CLUSTER,
    fault_plan=None,
    failover_owner: Optional[np.ndarray] = None,
    detect_delay: float = 0.0,
) -> ServingReport:
    """Drive a request trace through per-worker queues.

    `request_ids`/`arrivals` are the global trace (arrivals sorted,
    seconds); each request is routed to the worker owning its target
    vertex. Every worker batches greedily (`plan_dispatch`) and serves
    serially at the cost model's service time; modeled per-request latency
    = (dispatch wait) + (batch service time). Host compute is measured too
    and reported separately.

    Fault injection: a `fault_plan` with a `worker-death` event kills one
    worker at virtual time tau. Its unanswered requests fail over to
    `failover_owner` (see fault/recovery.failover_assignment) after
    `detect_delay` seconds; every request is STILL answered — the rerouted
    ones pay the delay plus the survivor's colder locality, which is the
    degraded-window latency `transition_stats()` reports. Latency and queue
    wait stay measured against the ORIGINAL arrival, so the per-request
    closure invariant (latency == queue_wait + service) survives the fault.
    The dead worker is drained first (up to tau), then the survivors in
    worker order, as the reference serves them.
    """
    request_ids = np.asarray(request_ids, dtype=np.int64)
    arrivals = np.asarray(arrivals, dtype=np.float64)
    k = len(engines)
    tracer = get_tracer()
    latencies, lat_worker, queue_waits, served_ids, logits = [], [], [], [], []
    arrival_rec: list[np.ndarray] = []
    reroute_done: list[np.ndarray] = []  # completion times of rerouted reqs
    host_times, service_times, bsizes, bworkers, bmiss = [], [], [], [], []
    all_stats: list[FetchStats] = []

    def _drain(w, ids_w, eff_w, orig_w, flag_w, stop_at=None):
        """Serve worker w's stream serially; dispatch is planned from the
        EFFECTIVE arrivals, latency measured from the ORIGINAL ones.
        Returns the index the worker died at (== len when it drained)."""
        t_free = 0.0
        i = 0
        while i < ids_w.shape[0]:
            take, t_dispatch = batchers[w].dispatch(eff_w, i, t_free)
            if stop_at is not None and t_dispatch >= stop_at:
                break  # the worker is dead before this batch dispatches
            mb = MicroBatch(
                ids=ids_w[i:i + take],
                arrivals=orig_w[i:i + take],
                dispatch_time=t_dispatch,
                batch=batchers[w].build_mfg(ids_w[i:i + take]),
            )
            out, stats, host_s = engines[w].answer(mb.batch)
            est = engines[w].estimate(mb.batch, stats, cluster)
            t_done = t_dispatch + est.service_time
            if stop_at is not None and t_done > stop_at:
                break  # died mid-batch: nothing of it was answered
            latencies.append(t_done - mb.arrivals)
            queue_waits.append(t_dispatch - mb.arrivals)
            arrival_rec.append(mb.arrivals)
            if flag_w is not None and flag_w[i:i + take].any():
                reroute_done.append(
                    np.full(int(flag_w[i:i + take].sum()), t_done))
            lat_worker.append(np.full(take, w, dtype=np.int64))
            served_ids.append(mb.ids)
            logits.append(out[:take])
            host_times.append(host_s)
            service_times.append(est.service_time)
            bsizes.append(take)
            bworkers.append(w)
            bmiss.append(stats.num_remote_miss)
            all_stats.append(stats)
            if tracer.enabled:
                # the request lifecycle on the simulator's virtual clock:
                # enqueue→dispatch per request on the worker's queue
                # track, then the modeled gather/compute service phases
                for rid, arr in zip(mb.ids, mb.arrivals):
                    tracer.record_span(
                        "serve.queue", float(arr), float(t_dispatch),
                        cat="serve", clock="model",
                        track=f"serve.worker{w}.queue",
                        args={"rid": int(rid)})
                t_fetch = t_dispatch + est.sample_time + est.fetch_time
                tracer.record_span(
                    "serve.service.gather", float(t_dispatch),
                    float(t_fetch), cat="serve", clock="model",
                    track=f"serve.worker{w}", args={"size": int(take)})
                tracer.record_span(
                    "serve.service.compute", float(t_fetch), float(t_done),
                    cat="serve", clock="model",
                    track=f"serve.worker{w}", args={"size": int(take)})
            t_free = t_done
            i += take
        return i

    # ----------------------------------------------------- fault resolution
    route = np.asarray(owner)[request_ids] if request_ids.size else \
        np.zeros(0, np.int64)
    death_ev, dead, fault_time = None, -1, None
    if fault_plan is not None:
        deaths = fault_plan.pending("worker-death")
        if deaths:
            death_ev = deaths[0]
            dead = fault_plan.resolve_worker(death_ev, k)
            fault_time = (float(death_ev.at) if death_ev.at >= 0 else
                          0.5 * float(arrivals.max() if arrivals.size else 0.0))
            if failover_owner is None:
                raise ValueError(
                    "worker-death injection requires failover_owner "
                    "(see fault.recovery.failover_assignment)")

    rerouted_n = 0
    extra = {w: None for w in range(k)}  # survivor -> rerouted (ids, orig)
    if death_ev is not None:
        sel = route == dead
        ids_d, orig_d = request_ids[sel], arrivals[sel]
        served = _drain(dead, ids_d, orig_d, orig_d, None,
                        stop_at=fault_time)
        fault_plan.fire(death_ev, worker=int(dead), at=fault_time)
        left_ids, left_orig = ids_d[served:], orig_d[served:]
        rerouted_n = int(left_ids.shape[0])
        tracer.add("fault.rerouted", rerouted_n)
        new_owner = np.asarray(failover_owner)
        targets = new_owner[left_ids]
        if (targets == dead).any():
            raise ValueError(
                f"failover_owner still routes to dead worker {dead}")
        for w in range(k):
            pick = targets == w
            if pick.any():
                extra[w] = (left_ids[pick], left_orig[pick])

    # ------------------------------------------------------------ the drain
    for w in range(k):
        if w == dead:
            continue
        sel = route == w
        ids_w, orig_w = request_ids[sel], arrivals[sel]
        flag_w = None
        if extra[w] is not None:
            re_ids, re_orig = extra[w]
            # rerouted requests become visible to the survivor only after
            # the death is detected
            re_eff = np.maximum(re_orig, fault_time + detect_delay)
            ids_w = np.concatenate([ids_w, re_ids])
            eff_w = np.concatenate([orig_w, re_eff])
            orig_w = np.concatenate([orig_w, re_orig])
            flag_w = np.zeros(ids_w.shape[0], dtype=bool)
            flag_w[-re_ids.shape[0]:] = True
            order = np.argsort(eff_w, kind="stable")
            ids_w, eff_w = ids_w[order], eff_w[order]
            orig_w, flag_w = orig_w[order], flag_w[order]
        else:
            eff_w = orig_w
        _drain(w, ids_w, eff_w, orig_w, flag_w)

    transition_end = None
    if death_ev is not None:
        transition_end = (float(np.max(np.concatenate(reroute_done)))
                          if reroute_done else float(fault_time))
        if tracer.enabled:
            tracer.record_span(
                "serve.worker_death", float(fault_time), transition_end,
                cat="fault", clock="model", track=f"serve.worker{dead}",
                args={"worker": int(dead), "rerouted": rerouted_n})
        fault_plan.mark_handled(death_ev)  # every rerouted request answered

    def cat(parts, empty):
        return np.concatenate(parts) if parts else empty

    return ServingReport(
        k=k,
        offered_qps=(request_ids.shape[0] / max(float(arrivals.max()), 1e-9)
                     if request_ids.size else 0.0),
        latency=cat(latencies, np.zeros(0)),
        latency_worker=cat(lat_worker, np.zeros(0, np.int64)),
        host_time=np.asarray(host_times),
        service_time=np.asarray(service_times),
        batch_size=np.asarray(bsizes, dtype=np.int64),
        batch_worker=np.asarray(bworkers, dtype=np.int64),
        fetch=FetchStats.merge(all_stats),
        duration=float(arrivals.max()) if arrivals.size else 0.0,
        queue_wait=cat(queue_waits, np.zeros(0)),
        batch_miss=np.asarray(bmiss, dtype=np.int64),
        served_ids=cat(served_ids, np.zeros(0, np.int64)),
        logits=cat(logits, None),
        arrival=cat(arrival_rec, np.zeros(0)),
        fault_time=fault_time,
        dead_worker=dead,
        rerouted=rerouted_n,
        transition_end=transition_end,
    )


def build_serving(
    graph,
    vbook,
    spec: GNNSpec,
    params: Any,
    embeddings: list,
    *,
    device: torch.device,
    hops: int = 1,
    fanout: int = 10,
    max_batch: int = 32,
    max_wait: float = 2e-3,
    cache_policy: str = "none",
    cache_budget: int = 0,
    seed: int = 0,
    codec=None,
) -> tuple[list, list, RowStore]:
    """Wire per-worker (engines, batchers) over one embedding store.

    `embeddings` is the `LayerwiseInference.run()` output (layer outputs,
    input side first); serving with `hops` recompute layers reads the
    layer-(L-1-hops) store; `codec` is the wire codec of its remote-miss
    rows."""
    L = spec.num_layers
    if hops == L:
        raise ValueError(
            "hops == num_layers is feature-store inference — use the "
            "mini-batch path; serving reads embeddings")
    source = embeddings[L - 1 - hops]
    store = build_embedding_stores(
        graph, vbook, [source], policy=cache_policy, budget=cache_budget,
        seed=seed, codec=codec,
    )[0]
    fanouts = (fanout,) * hops
    tiled = spec.agg_backend != "scatter"
    engines, batchers = [], []
    for w in range(vbook.k):
        batchers.append(MicroBatcher.build(
            graph, fanouts=fanouts, max_batch=max_batch, owner=vbook.owner,
            worker=w, tiled_layout=tiled, max_wait=max_wait, seed=seed + w,
        ))
        engines.append(ServeEngine(
            spec=spec, params=params, store=store,
            plan=batchers[w].plan, hops=hops, worker=w, device=device,
        ))
    return engines, batchers, store

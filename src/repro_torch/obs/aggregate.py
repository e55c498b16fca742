"""Shared span/metric aggregation helpers (twin of repro/obs/aggregate.py).

One home for the reductions the consumers share: per-step phase walls
reduce to the six-column summary of :func:`phase_means` (the reference's
``core.study.host_phase_means`` and ``benchmarks/fig19_phase_times.py``
reduce the same way), and the serving row's queue-vs-service breakdown
comes from :func:`request_breakdown`.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np

from .trace import SpanEvent

__all__ = ["PHASES", "phase_means", "span_summary", "request_breakdown"]

#: canonical phase order: the four host phases of one mini-batch step
PHASES = ("sample", "fetch", "transfer", "compute")


def phase_means(metrics) -> dict:
    """Mean MEASURED host/device phase wall times over a list of
    `StepMetrics` — the `host_*` columns of a mini-batch row (this
    container's clock, unlike the modeled paper-cluster `*_time` columns).

    Each per-step value is a span duration (the phase spans recorded by
    the pipeline's `PhaseClock` plus the step/compute span), so every
    consumer of these columns reduces the same timing source."""
    return {
        "host_sample_time": float(np.mean([m.sample_time_host for m in metrics])),
        "host_fetch_time": float(np.mean([m.fetch_time_host for m in metrics])),
        "host_transfer_time": float(np.mean([m.transfer_time_host for m in metrics])),
        "host_compute_time": float(np.mean([m.compute_time_host for m in metrics])),
        "host_step_wall": float(np.mean([m.step_wall_host for m in metrics])),
        "overlap_efficiency": float(np.mean([m.overlap_efficiency for m in metrics])),
    }


def span_summary(spans: Iterable[SpanEvent]) -> Dict[str, dict]:
    """Per-name duration statistics over recorded spans:
    ``{name: {count, total_s, mean_s, p50_s, p99_s}}``."""
    by_name: Dict[str, List[float]] = {}
    for e in spans:
        by_name.setdefault(e.name, []).append(e.duration)
    out: Dict[str, dict] = {}
    for name, ds in sorted(by_name.items()):
        a = np.asarray(ds, dtype=np.float64)
        out[name] = {
            "count": int(a.size),
            "total_s": float(a.sum()),
            "mean_s": float(a.mean()),
            "p50_s": float(np.percentile(a, 50)),
            "p99_s": float(np.percentile(a, 99)),
        }
    return out


def request_breakdown(latency: np.ndarray,
                      queue_wait: Optional[np.ndarray]) -> dict:
    """Queue-wait vs service-time attribution over per-request serving
    latencies (both arrays come from the request spans: queue span =
    enqueue→dispatch, service span = dispatch→done, latency = their sum).

    ``p99_queue_share`` is the mean fraction of latency spent queueing
    among the slowest 1% of requests — the number that says whether a p99
    regression is a queueing problem or a compute problem."""
    lat = np.asarray(latency, dtype=np.float64)
    if queue_wait is None or lat.size == 0:
        return {}
    qw = np.asarray(queue_wait, dtype=np.float64)
    service = lat - qw
    p99 = np.percentile(lat, 99)
    tail = lat >= p99
    share = float(np.mean(qw[tail] / np.maximum(lat[tail], 1e-12)))
    return {
        "queue_wait_p50": float(np.percentile(qw, 50)),
        "queue_wait_p99": float(np.percentile(qw, 99)),
        "queue_wait_mean": float(qw.mean()),
        "service_p50": float(np.percentile(service, 50)),
        "service_p99": float(np.percentile(service, 99)),
        "service_mean_req": float(service.mean()),
        "p99_queue_share": share,
    }

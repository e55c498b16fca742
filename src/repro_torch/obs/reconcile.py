"""Measured-vs-model reconciliation (twin of repro/obs/reconcile.py).

This module holds a REAL run's spans, counters and collective records to
the analytic predictions:

  * feature-fetch wire bytes measured at the encode site
    (`RowStore.gather` counts the actual encoded payload+meta nbytes)
    against `Codec.wire_bytes` per gather — exact for every codec;
  * fetch miss bytes against the logical miss·d·4 volume — exact;
  * full-batch collective counts and cluster bytes recorded by the sync
    strategies against `collective_budget`, and forward sync wire bytes
    against `sync_wire_bytes_per_round` — exact, at the reference's byte
    conventions (the stacked [k, ...] tensors hold the k devices' buffers,
    so their size is the reference's per-device size times k). The
    reference records one set when jax traces the step; the port records
    one set per forward pass, each stamped with the pass's ordinal, so the
    check reads one pass and first requires every recorded pass to agree;
  * per-epoch wire bytes against `FullBatchTrainer.wire_bytes_per_epoch`;
  * gradient all-reduce bytes against `cost_model.minibatch_step`'s
    parameter count — a model-granularity check (the analytic count drops
    biases/attention vectors), so it carries a documented 25% tolerance;
  * phase walls: sample+fetch+transfer+compute against the step wall;
  * fault accounting (`reconcile_recovery`): the tracer's fault.injected /
    fault.handled counters against the `FaultPlan`'s own books — exact —
    and the fault.recovery_time_model counter against the recomputed
    `RecoveryEstimate` sum, one recovery span per executed rescale.

Fetch-byte and phase checks apply to the serial engine; the pipelined
engine prefetches beyond the consumed steps and interleaves phases by
design, so those checks warn-skip there instead of faking a tolerance.

Tolerances are per quantity, as in the reference. ``tol_rel == 0.0`` means a bitwise ``measured == predicted`` comparison —
fp32 byte counts must match exactly, not approximately.

The report (schema ``gnn-trace-report/v2``, the reference's): programs, counts by level, exit_code (1 on any error), and one entry per
check with measured/predicted/tolerance detail.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .trace import Tracer, get_tracer

__all__ = ["REPORT_SCHEMA", "Check", "ReconcileReport", "make_check",
           "build_report", "reconcile_minibatch", "reconcile_fullbatch",
           "reconcile_serving", "reconcile_recovery"]

# v2: adds the recovery rule (fault.* counters/spans vs the FaultPlan's
# books and the cost model's RecoveryEstimate)
REPORT_SCHEMA = "gnn-trace-report/v2"


@dataclasses.dataclass
class Check:
    """One reconciled quantity. ``level`` is "ok" when it holds, "error"
    when it does not, "warn" for advisory-only findings (never exit 1)."""

    quantity: str
    program: str
    measured: float
    predicted: float
    tol_rel: float
    level: str
    message: str
    unit: str = "bytes"
    data: Optional[dict] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["data"] is None:
            d.pop("data")
        return d


def make_check(quantity: str, program: str, measured, predicted, *,
               tol_rel: float = 0.0,
               bounds: Optional[Tuple[float, float]] = None,
               unit: str = "bytes", note: str = "",
               warn_only: bool = False,
               data: Optional[dict] = None) -> Check:
    """Compare one measured quantity against its prediction.

    ``tol_rel == 0.0`` is a bitwise equality check (the fp32 contract);
    ``bounds=(lo, hi)`` checks containment instead (collective op counts,
    phase-closure deviations).
    """
    measured = float(measured)
    if bounds is not None:
        lo, hi = float(bounds[0]), float(bounds[1])
        ok = lo <= measured <= hi
        predicted = hi
        detail = f"measured {measured:g} vs bounds [{lo:g}, {hi:g}]"
    else:
        predicted = float(predicted)
        if tol_rel == 0.0:
            ok = measured == predicted
            detail = f"measured {measured:g} vs predicted {predicted:g} (exact)"
        else:
            rel = abs(measured - predicted) / max(abs(predicted), 1e-12)
            ok = rel <= tol_rel
            detail = (f"measured {measured:g} vs predicted {predicted:g} "
                      f"(rel dev {rel:.3g}, tol {tol_rel:g})")
    if note:
        detail += f" — {note}"
    level = "ok" if ok else ("warn" if warn_only else "error")
    return Check(quantity=quantity, program=program, measured=measured,
                 predicted=float(predicted), tol_rel=float(tol_rel),
                 level=level, message=detail, unit=unit, data=data)


def _skip(quantity: str, program: str, why: str) -> Check:
    return Check(quantity=quantity, program=program, measured=float("nan"),
                 predicted=float("nan"), tol_rel=0.0, level="warn",
                 message=f"not reconciled: {why}", unit="")


@dataclasses.dataclass
class ReconcileReport:
    checks: List[Check]
    programs: List[str]
    elapsed_s: float = 0.0

    @property
    def counts(self) -> Dict[str, int]:
        c = {"error": 0, "warn": 0, "ok": 0}
        for ch in self.checks:
            c[ch.level] = c.get(ch.level, 0) + 1
        return c

    @property
    def exit_code(self) -> int:
        return 1 if self.counts.get("error") else 0

    def to_dict(self) -> dict:
        return {
            "schema": REPORT_SCHEMA,
            "programs": list(self.programs),
            "counts": self.counts,
            "exit_code": self.exit_code,
            "elapsed_s": self.elapsed_s,
            "checks": [c.to_dict() for c in self.checks],
        }


def build_report(checks: Sequence[Check],
                 elapsed_s: float = 0.0) -> ReconcileReport:
    programs = sorted({c.program for c in checks})
    return ReconcileReport(checks=list(checks), programs=programs,
                           elapsed_s=elapsed_s)


def _wb(codec, shape, layer: int = 0) -> int:
    try:
        return codec.wire_bytes(tuple(shape), layer=layer)
    except TypeError:  # fixed-ratio codecs take no layer kwarg
        return codec.wire_bytes(tuple(shape))


def _leaf_wire(codec, params) -> int:
    """Encoded bytes of every parameter leaf (the port's parameter tree:
    `optim.leaves`, the reference's `jax.tree.leaves`)."""
    from repro_torch.optim import leaves

    return sum(_wb(codec, p.shape) for p in leaves(params))


def _forward_passes(events) -> List[list]:
    """Collective events grouped by the forward pass that recorded them,
    in recording order."""
    passes: Dict[int, list] = {}
    for e in events:
        passes.setdefault(e.forward, []).append(e)
    return list(passes.values())


def _pass_totals(events) -> dict:
    """One pass's {kind: (ops, cluster bytes, wire bytes)}."""
    out: Dict[str, Tuple[int, int, int]] = {}
    for e in events:
        n, c, w = out.get(e.kind, (0, 0, 0))
        out[e.kind] = (n + 1, c + e.cluster_bytes, w + (e.wire_bytes or 0))
    return out


# ---------------------------------------------------------------------------
# mini-batch training (DistDGL regime)
# ---------------------------------------------------------------------------


def reconcile_minibatch(trainer, metrics, *, tracer: Optional[Tracer] = None,
                        program: str = "minibatch") -> List[Check]:
    """Reconcile a mini-batch run. ``metrics`` must hold the `StepMetrics`
    of EVERY step executed while ``tracer`` was installed (the fetch
    counters are cumulative over the whole traced run)."""
    from repro_torch.core.cost_model import _wire_elem
    from repro_torch.core.wire import as_codec

    tracer = tracer or get_tracer()
    codec = as_codec(trainer.codec)
    d = int(trainer.store.row_dim)
    k = int(trainer.book.k)
    checks: List[Check] = []

    miss_counts = [int(c) for m in metrics for c in m.remote_misses]
    pred_wire = sum(_wb(codec, (c, d)) for c in miss_counts)
    pred_miss = sum(c * d * 4 for c in miss_counts)

    meas_wire = tracer.total("fetch.wire_bytes")
    meas_miss = tracer.total("fetch.miss_bytes")
    if meas_wire is None:
        checks.append(_skip("fetch.wire_bytes", program,
                            "no fetch counters recorded (tracing was not "
                            "enabled during the steps)"))
    elif getattr(trainer, "overlap", False):
        # the prefetcher prepares batches AHEAD of consumption (and drops
        # queued ones at close), so the measured gather counters cover a
        # superset of the consumed steps' predictions
        checks.append(_skip("fetch.wire_bytes", program,
                            "pipelined engine: the prefetcher fetches "
                            "beyond the consumed steps by design"))
    else:
        checks.append(make_check(
            "fetch.wire_bytes", program, meas_wire, pred_wire,
            note="encoded payload+meta nbytes at the gather site vs "
                 "Codec.wire_bytes per gather"))
        checks.append(make_check(
            "fetch.miss_bytes", program, meas_miss or 0.0, pred_miss,
            note="logical f32 miss rows"))
        if not codec.lossless and pred_miss > 0:
            checks.append(make_check(
                "fetch.wire_ratio", program, meas_wire / pred_miss,
                codec.ratio(0), tol_rel=0.05, unit="ratio",
                note="codec width ratio; slack covers the O(1) per-gather "
                     "scale meta"))

    # gradient all-reduce: the live parameter tree vs the analytic count
    # (model granularity: cost_model drops biases/attention vectors)
    leaf_wire = _leaf_wire(codec, trainer.params)
    n_params_model = sum(din * dout for din, dout in trainer.spec.dims()) * 2
    checks.append(make_check(
        "allreduce.wire_bytes", program,
        2 * k * leaf_wire, 2 * k * n_params_model * _wire_elem(codec),
        tol_rel=0.25,
        note="2k x encoded param leaves vs the cost model's dense "
             "parameter count (biases excluded by design)"))

    # phase closure: the four phases must sum to the step wall (serial
    # engine; the pipelined engine overlaps phases across threads)
    if metrics:
        if getattr(trainer, "overlap", False):
            checks.append(_skip(
                "phase.closure", program,
                "pipelined engine: phases overlap across threads by design"))
        else:
            dev = max(
                abs(m.sample_time_host + m.fetch_time_host
                    + m.transfer_time_host + m.compute_time_host
                    - m.step_wall_host) / max(m.step_wall_host, 1e-12)
                for m in metrics)
            checks.append(make_check(
                "phase.closure", program, dev, 0.0, bounds=(0.0, 1e-9),
                unit="rel", note="max |sample+fetch+transfer+compute - "
                                 "wall| / wall over steps"))
    return checks


# ---------------------------------------------------------------------------
# full-batch training (sync-strategy collectives)
# ---------------------------------------------------------------------------


def reconcile_fullbatch(trainer, *, tracer: Optional[Tracer] = None,
                        program: str = "fullbatch") -> List[Check]:
    """Reconcile the collectives a full-batch trainer recorded against
    `collective_budget` / `sync_wire_bytes_per_round`.

    Every forward pass run while the tracer was installed records its
    collectives (a tracer installed after step 1 records step 2 in full:
    nothing is compiled once and cached). Predictions cover one forward
    pass, every aggregate priced at its true payload width
    (`GNNSpec.aggregate_dims`) — exact for fp32, every model. The passes
    must agree with each other (an error names the first that does not);
    the first is the one reconciled.
    """
    from repro_torch.core.wire import as_codec
    from repro_torch.gnn.fullbatch import resolve_sync_mode
    from repro_torch.gnn.sync import (collective_budget,
                                      sync_wire_bytes_per_round)

    tracer = tracer or get_tracer()
    book, spec = trainer.book, trainer.spec
    codec = as_codec(trainer.codec)
    mode = resolve_sync_mode(trainer.sync_mode, book.k)
    events = tracer.collectives()
    checks: List[Check] = []

    if mode == "local":
        checks.append(make_check(
            "sync.collective_count", program, len(events), 0, unit="ops",
            note="k=1 resolves to LocalSync: nothing may move"))
        return checks
    if not events:
        checks.append(_skip(
            "sync.collectives", program,
            "no collectives recorded — no forward pass ran while the "
            "tracer was installed"))
        return checks
    passes = _forward_passes(events)
    first = _pass_totals(passes[0])
    for i, p in enumerate(passes[1:], 1):
        if _pass_totals(p) != first:
            checks.append(make_check(
                "sync.forward_passes", program, i, len(passes),
                unit="passes", note="recorded forward passes disagree: "
                                    f"pass {i} differs from pass 0"))
            break
    events = passes[0]

    pred: Dict[str, List[float]] = {}   # kind -> [lo, hi, cluster_bytes]
    pred_wire_fwd = 0
    ordinal = 0  # aggregate ordinal == the codec layer= the sync passes
    for layer_dims in spec.aggregate_dims(mode):
        for d in layer_dims:
            pred_wire_fwd += sync_wire_bytes_per_round(
                book, d, mode, codec, layer=ordinal)
            for kind, b in collective_budget(
                    book, d, mode, codec, layer=ordinal).items():
                lo, hi = b["count"]
                acc = pred.setdefault(kind, [0.0, 0.0, 0.0])
                acc[0] += lo
                acc[1] += hi
                acc[2] += b["cluster_bytes"]
            ordinal += 1

    meas: Dict[str, List[float]] = {}   # kind -> [count, cluster_bytes]
    meas_wire_fwd = 0
    for e in events:
        acc = meas.setdefault(e.kind, [0.0, 0.0])
        acc[0] += 1
        acc[1] += e.cluster_bytes
        if e.wire_bytes is not None:
            meas_wire_fwd += e.wire_bytes

    for kind in sorted(set(pred) | set(meas)):
        p = pred.get(kind, [0.0, 0.0, 0.0])
        m = meas.get(kind, [0.0, 0.0])
        checks.append(make_check(
            f"sync.count.{kind}", program, m[0], p[1],
            bounds=(p[0], p[1]), unit="ops",
            note="recorded ops of one forward pass vs collective_budget"))
        checks.append(make_check(
            f"sync.cluster_bytes.{kind}", program, m[1], p[2],
            note="HLO output-shape convention (per-device output x k)"))

    if mode in ("halo", "ring"):
        # the dense transport formula prices the quantised view while the
        # psum moves dequantised f32 — only halo/ring wire is reconcilable
        checks.append(make_check(
            "sync.wire_bytes.forward", program, meas_wire_fwd,
            pred_wire_fwd,
            note="encoded payload+meta x devices, one forward pass, vs "
                 "sum of sync_wire_bytes_per_round over aggregates"))

        leaf_wire = _leaf_wire(codec, trainer.params)
        checks.append(make_check(
            "epoch.wire_bytes", program,
            2 * meas_wire_fwd + 2 * book.k * leaf_wire,
            trainer.wire_bytes_per_epoch(),
            note="2x recorded forward sync wire + grad all-reduce vs "
                 "FullBatchTrainer.wire_bytes_per_epoch"))
    return checks


# ---------------------------------------------------------------------------
# online serving (embedding-store fetches + request lifecycle)
# ---------------------------------------------------------------------------


def reconcile_serving(report, store, *, tracer: Optional[Tracer] = None,
                      program: str = "serve") -> List[Check]:
    """Reconcile a serving-sim run: embedding-store wire bytes measured at
    the gather encode site vs the codec formula, the merged FetchStats
    accounting, and the request-latency closure (queue span + service
    span == latency span, on the simulator's virtual clock)."""
    from repro_torch.core.wire import as_codec

    tracer = tracer or get_tracer()
    codec = as_codec(getattr(store, "codec", None))
    d = int(store.row_dim)
    checks: List[Check] = []

    batch_miss = getattr(report, "batch_miss", None)
    if batch_miss is None:
        return [_skip("serve.fetch.wire_bytes", program,
                      "report carries no per-batch miss counts")]
    pred_wire = sum(_wb(codec, (int(c), d)) for c in batch_miss)

    meas_wire = tracer.total("fetch.wire_bytes")
    if meas_wire is None:
        checks.append(_skip("serve.fetch.wire_bytes", program,
                            "no fetch counters recorded (tracing was not "
                            "enabled during the sim)"))
    else:
        checks.append(make_check(
            "serve.fetch.wire_bytes", program, meas_wire, pred_wire,
            note="encoded embedding rows at the gather site vs "
                 "Codec.wire_bytes per micro-batch"))
    checks.append(make_check(
        "serve.fetch.stats_wire_bytes", program, report.fetch.wire_bytes,
        pred_wire, note="merged FetchStats accounting vs per-batch sum"))
    checks.append(make_check(
        "serve.fetch.miss_bytes", program, report.fetch.miss_bytes,
        sum(int(c) * d * 4 for c in batch_miss),
        note="logical f32 embedding miss rows"))

    qw = getattr(report, "queue_wait", None)
    if qw is not None and report.latency.size:
        # each request's service share (latency minus its queue span) must
        # equal its batch's modeled service span
        service = report.latency - np.asarray(qw)
        by_batch = np.repeat(report.service_time, report.batch_size.astype(int))
        dev = float(np.max(np.abs(np.sort(service) - np.sort(by_batch))))
        checks.append(make_check(
            "serve.latency.closure", program, dev, 0.0,
            bounds=(0.0, 1e-9), unit="s",
            note="latency == queue span + its batch's service span, per "
                 "request (virtual clock)"))
    return checks


# ---------------------------------------------------------------------------
# fault injection + recovery (the chaos accounting)
# ---------------------------------------------------------------------------


def reconcile_recovery(plan, *, tracer: Optional[Tracer] = None,
                       estimates: Optional[Sequence] = None,
                       program: str = "recovery") -> List[Check]:
    """Reconcile a faulted run's trace against the `FaultPlan`'s own books.

    The plan counts what it injected and what the run reported handled;
    the tracer counted the same events from the run's side — the two
    stories must agree EXACTLY, or a fault was dropped/double-counted.
    With `estimates` (the `RecoveryEstimate`s of an elastic run) the traced
    `fault.recovery_time_model` counter must equal their recomputed sum and
    the run must have recorded exactly one recovery span per rescale.
    """
    tracer = tracer or get_tracer()
    checks: List[Check] = []

    injected = tracer.total("fault.injected")
    checks.append(make_check(
        "fault.injected", program, injected or 0.0,
        plan.injected_count, unit="ops",
        note="traced injection counter vs the plan's fired-event book"))
    handled = tracer.total("fault.handled")
    checks.append(make_check(
        "fault.handled", program, handled or 0.0,
        plan.handled_count, unit="ops",
        note="traced handled counter vs the plan's handled-event book"))

    if estimates is not None:
        pred_total = float(sum(e.recovery_time for e in estimates))
        meas_total = tracer.total("fault.recovery_time_model")
        checks.append(make_check(
            "fault.recovery_time_model", program, meas_total or 0.0,
            pred_total, unit="s",
            note="traced recovery-time counter vs the recomputed "
                 "RecoveryEstimate sum (restore + re-partition + "
                 "re-compile)"))
        checks.append(make_check(
            "fault.recovery_spans", program,
            len(tracer.spans("fault.recovery")), len(estimates), unit="ops",
            note="one fault.recovery span per executed rescale"))
    return checks

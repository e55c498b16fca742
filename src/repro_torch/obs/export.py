"""Chrome trace-event / Perfetto export for :mod:`repro_torch.obs.trace`.

Twin of repro/obs/export.py: the same payload, so a trace either package
writes loads through the other's `load_trace`.

Schema tag: ``gnn-trace/v1`` (in ``otherData.schema``). The payload is
the standard JSON-object trace-event format, loadable by Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing``:

  * one **process** per clock — pid 1 = ``host`` (wall-clock
    ``perf_counter`` spans), pid 2 = ``model`` (the serving simulator's
    virtual timeline) — so measured and modeled time never share an axis;
  * one **track** (tid) per thread or logical track, named via ``M``
    (metadata) events: the producer thread, each sampler-pool worker, the
    consumer, and per-worker serving queues each get their own row;
  * spans as paired ``B``/``E`` duration events (args on the ``B``);
  * counters (wire bytes, cache hit rate, queue depth, prefetch-queue
    occupancy) as ``C`` events on per-counter tracks.

Timestamps are microseconds relative to the earliest event per clock.
``load_trace`` is the exporter's own loader: it re-parses the JSON and
*validates* it (schema tag, every ``B`` paired with an ``E`` on its
track, per-track timestamps monotonically non-decreasing) — the
round-trip the CLI and the tests run.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Tuple, Union

from .trace import CounterEvent, SpanEvent, Tracer

__all__ = ["TRACE_SCHEMA", "to_chrome_trace", "write_trace", "load_trace",
           "validate_chrome_trace"]

TRACE_SCHEMA = "gnn-trace/v1"

_PIDS = {"wall": 1, "model": 2}
_PROC_NAMES = {1: "host", 2: "model (simulated serving clock)"}


def _collect(tracers: Union[Tracer, Iterable[Tracer]]
             ) -> Tuple[List[SpanEvent], List[CounterEvent]]:
    if isinstance(tracers, Tracer):
        tracers = (tracers,)
    spans: List[SpanEvent] = []
    counters: List[CounterEvent] = []
    for tr in tracers:
        spans.extend(tr.spans())
        counters.extend(tr.counters())
    return spans, counters


def to_chrome_trace(tracers: Union[Tracer, Iterable[Tracer]]) -> dict:
    """Render recorded spans + counters as a Chrome trace-event object."""
    spans, counters = _collect(tracers)

    # microsecond timestamps relative to the earliest event *per clock*
    # (wall and model timelines have unrelated origins)
    t0: Dict[str, float] = {}
    for e in spans:
        t0[e.clock] = min(t0.get(e.clock, e.t0), e.t0)
    for c in counters:
        t0[c.clock] = min(t0.get(c.clock, c.t), c.t)

    def us(t: float, clock: str) -> float:
        return round((t - t0[clock]) * 1e6, 3)

    # stable tid assignment per (pid, track) in first-seen order; a span
    # without an explicit track lands on its recording thread's track
    tids: Dict[Tuple[int, str], int] = {}
    next_tid: Dict[int, int] = {}

    def tid_of(pid: int, track: str) -> int:
        key = (pid, track)
        if key not in tids:
            next_tid[pid] = next_tid.get(pid, 0) + 1
            tids[key] = next_tid[pid]
        return tids[key]

    events: List[dict] = []
    for e in spans:
        pid = _PIDS[e.clock]
        track = e.track if e.track is not None else e.thread
        tid = tid_of(pid, track)
        b = {"name": e.name, "cat": e.cat or "span", "ph": "B",
             "ts": us(e.t0, e.clock), "pid": pid, "tid": tid}
        if e.args:
            b["args"] = e.args
        events.append(b)
        events.append({"name": e.name, "cat": e.cat or "span", "ph": "E",
                       "ts": us(e.t1, e.clock), "pid": pid, "tid": tid})
    for c in counters:
        pid = _PIDS[c.clock]
        events.append({"name": c.name, "cat": "counter", "ph": "C",
                       "ts": us(c.t, c.clock), "pid": pid,
                       "tid": tid_of(pid, f"counter:{c.name}"),
                       "args": {"value": c.value}})

    # deterministic order: by timestamp, B before E at equal ts (keeps the
    # pairing stack non-negative for zero-duration spans), then pid/tid
    ph_rank = {"B": 0, "C": 1, "E": 2}
    events.sort(key=lambda ev: (ev["pid"], ev["tid"], ev["ts"],
                                ph_rank[ev["ph"]]))

    meta: List[dict] = []
    for pid in sorted({ev["pid"] for ev in events}):
        meta.append({"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
                     "args": {"name": _PROC_NAMES[pid]}})
    for (pid, track), tid in sorted(tids.items(), key=lambda kv: kv[1]):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": track}})

    return {
        "traceEvents": meta + events,
        "displayTimeUnit": "ms",
        "otherData": {"schema": TRACE_SCHEMA},
    }


def write_trace(path: str,
                tracers: Union[Tracer, Iterable[Tracer]]) -> dict:
    """Write the Chrome trace JSON to ``path``; returns the payload."""
    payload = to_chrome_trace(tracers)
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1)
        fh.write("\n")
    return payload


def validate_chrome_trace(payload: dict) -> List[str]:
    """Structural validation; returns a list of problems (empty = valid).

    Checks: the schema tag, the event-list shape, every ``B`` paired with
    an ``E`` on the same (pid, tid), and per-(pid, tid) timestamps
    monotonically non-decreasing.
    """
    problems: List[str] = []
    schema = payload.get("otherData", {}).get("schema")
    if schema != TRACE_SCHEMA:
        problems.append(f"schema {schema!r} != {TRACE_SCHEMA!r}")
    events = payload.get("traceEvents")
    if not isinstance(events, list):
        return problems + ["traceEvents is not a list"]

    stacks: Dict[Tuple[int, int], List[str]] = {}
    last_ts: Dict[Tuple[int, int], float] = {}
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph == "M":
            continue
        key = (ev.get("pid"), ev.get("tid"))
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)):
            problems.append(f"event {i}: non-numeric ts {ts!r}")
            continue
        if ts < last_ts.get(key, float("-inf")):
            problems.append(
                f"event {i}: ts {ts} < {last_ts[key]} on track {key}")
        last_ts[key] = ts
        if ph == "B":
            stacks.setdefault(key, []).append(ev.get("name", ""))
        elif ph == "E":
            # match by name, newest first: contiguous phases share their
            # boundary timestamp (one clock reading ends span A and starts
            # span B), and the B-before-E tiebreak then interleaves the
            # pairs — a strict LIFO pop would mispair them
            stack = stacks.get(key, [])
            name = ev.get("name", "")
            for j in range(len(stack) - 1, -1, -1):
                if stack[j] == name:
                    del stack[j]
                    break
            else:
                problems.append(
                    f"event {i}: E {name!r} with no open B on track {key}")
        elif ph != "C":
            problems.append(f"event {i}: unknown phase {ph!r}")
    for key, stack in stacks.items():
        if stack:
            problems.append(f"track {key}: {len(stack)} unclosed B event(s) "
                            f"({stack[:3]}...)")
    return problems


def load_trace(path: str) -> dict:
    """Parse and validate a trace written by :func:`write_trace`.

    Raises ``ValueError`` listing every structural problem; this is the
    loader half of the exporter round-trip the CI smoke exercises.
    """
    with open(path) as fh:
        payload = json.load(fh)
    problems = validate_chrome_trace(payload)
    if problems:
        raise ValueError(
            f"{path}: invalid gnn-trace payload: " + "; ".join(problems))
    return payload

"""Thread-aware span tracer: the single timing substrate of the port.

Twin of repro/obs/trace.py. Every host-side duration the port reports —
pipeline phase times, trainer step walls, layer-wise inference times,
serving gather/compute splits — is derived from the spans recorded here,
so there is exactly one timing source of truth (``time.perf_counter``, a
monotonic clock) instead of ad-hoc ``perf_counter()`` pairs per module.

Design constraints, in order:

  * **Disabled means untouched.** The module-level singleton starts
    disabled; every record method is a single attribute check away from a
    no-op, and the :class:`PhaseClock` used on the pipeline hot path
    takes exactly as many ``perf_counter()`` readings as the inline
    timestamps it replaced. The "four phases sum exactly to the step
    wall" invariant and the overlapped==serial bitwise tests hold with
    tracing on or off because the *timestamps themselves* are what feed
    ``StepMetrics`` — the spans are the same numbers, not a second clock.
    A call site whose duration nothing else reads opens its span only
    when the tracer is enabled, so a disabled tracer reads no extra clock.
  * **Device spans are host spans that end after a wait.** PyTorch runs
    eagerly and launches asynchronously: a host span covers the device
    work it launched only if it ends after something that waits for the
    card. Each span over device work is a number the port already
    reports (``StepMetrics``, ``layer_times``, the serving host time) and
    ends where that number's timing waits: ``fullbatch.step`` and the
    mini-batch step spans after the loss is read back (``float(loss)``),
    ``inference.layer`` and ``serve.compute`` after a
    ``torch.cuda.synchronize()``, ``pipeline.transfer`` after the copy's
    event. The tracer itself adds no synchronize and uses no CUDA events:
    tracing on or off, the card sees the same stream of work.
  * **Thread-aware.** Spans capture the recording thread's name/ident at
    record time; the exporter lays producer, sampler-pool workers and the
    consumer out on separate tracks. A ``track=`` override places events
    on a logical track instead (e.g. per-worker serving queues), and
    ``clock="model"`` marks virtual-time spans from the serving simulator
    so they export under their own process and never mix timelines with
    wall-clock spans.
  * **Bounded.** Events land in ring buffers (``deque(maxlen=...)``), so
    a long traced run degrades to "most recent N events" instead of
    unbounded memory. Counter *totals* are kept separately and never
    truncate — reconciliation sums stay exact even if the event ring
    wrapped.

Byte accounting rides the same tracer: cumulative counters (``add``),
gauges (``gauge``) and collective records (``collective``, fed by the
sync strategies) are what ``obs.reconcile`` holds against the analytic
cost model. The reference records a collective once, when jax traces the
step; the port runs eagerly and records one set per forward pass
(``forward_logits_global`` included), so its reconcile reads one
forward's events.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional

__all__ = [
    "SpanEvent", "CounterEvent", "CollectiveEvent", "Span", "PhaseClock",
    "Tracer", "get_tracer", "install", "uninstall", "tracing", "traced",
]

_DEFAULT_CAPACITY = 1 << 16


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One closed span: ``[t0, t1]`` on the recording thread's track."""

    name: str
    cat: str
    t0: float
    t1: float
    tid: int
    thread: str
    track: Optional[str] = None
    clock: str = "wall"          # "wall" (perf_counter) | "model" (sim time)
    args: Optional[dict] = None

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass(frozen=True)
class CounterEvent:
    """A counter sample: cumulative (``add``) or instantaneous (``gauge``)."""

    name: str
    t: float
    value: float
    track: Optional[str] = None
    clock: str = "wall"


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective op recorded by a sync strategy, once per forward.

    ``cluster_bytes`` follows the compiled-HLO output-shape convention the
    static gate's ``collective_budget`` uses (per-device output nbytes x
    k); ``wire_bytes`` follows the transport convention of
    ``sync_wire_bytes_per_round`` (k x per-device encoded payload+meta).
    ``wire_bytes`` is ``None`` where the transport formula intentionally
    diverges from what the op moves (DenseSync reduces *decoded* fp32).
    """

    kind: str
    cluster_bytes: int
    wire_bytes: Optional[int] = None
    layer: int = 0
    program: str = "sync"
    forward: int = 0             # ordinal of the forward pass that ran it


class Span:
    """Context-manager span. Always measures (``duration`` is consumed by
    the call sites even when tracing is off); records only when enabled."""

    __slots__ = ("_tracer", "name", "cat", "track", "args", "t0", "t1")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 track: Optional[str], args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.track = track
        self.args = args
        self.t0 = 0.0
        self.t1 = 0.0

    def __enter__(self) -> "Span":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        tr = self._tracer
        if tr.enabled:
            tr.record_span(self.name, self.t0, self.t1, cat=self.cat,
                           track=self.track, args=self.args)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class PhaseClock:
    """Contiguous phase timer: each ``split`` closes the current phase at
    the exact instant the next one opens, so phase durations sum to the
    wall *bitwise* (the same ``perf_counter`` reading ends one span and
    starts the next — no gap, no overlap, and exactly one clock reading
    per boundary, matching the inline ``t0..t3`` code it replaced)."""

    __slots__ = ("_tracer", "cat", "track", "args", "_t")

    def __init__(self, tracer: "Tracer", cat: str, track: Optional[str],
                 args: Optional[dict]):
        self._tracer = tracer
        self.cat = cat
        self.track = track
        self.args = args
        self._t = time.perf_counter()

    def split(self, name: str) -> float:
        """Close the running phase as ``name``; return its duration."""
        t0, t1 = self._t, time.perf_counter()
        self._t = t1
        tr = self._tracer
        if tr.enabled:
            tr.record_span(name, t0, t1, cat=self.cat, track=self.track,
                           args=self.args)
        return t1 - t0


class Tracer:
    """Ring-buffered event sink. Thread-safe: spans/counters append from
    the producer thread, sampler pool and consumer concurrently (deque
    appends are atomic under the GIL; totals take a small lock)."""

    def __init__(self, enabled: bool = True,
                 capacity: int = _DEFAULT_CAPACITY):
        self.enabled = enabled
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._counters: collections.deque = collections.deque(maxlen=capacity)
        self._collectives: collections.deque = collections.deque(
            maxlen=capacity)
        self._totals: Dict[str, float] = {}
        self._lock = threading.Lock()

    # -- recording ----------------------------------------------------------

    def span(self, name: str, *, cat: str = "span",
             track: Optional[str] = None,
             args: Optional[dict] = None) -> Span:
        return Span(self, name, cat, track, args)

    def phase_clock(self, *, cat: str = "phase",
                    track: Optional[str] = None,
                    args: Optional[dict] = None) -> PhaseClock:
        return PhaseClock(self, cat, track, args)

    def record_span(self, name: str, t0: float, t1: float, *,
                    cat: str = "span", track: Optional[str] = None,
                    clock: str = "wall", args: Optional[dict] = None) -> None:
        """Record a span from explicit timestamps (the migration path for
        call sites that already hold ``perf_counter`` readings, and the
        only path for virtual-time spans, which pass ``clock='model'``)."""
        if not self.enabled:
            return
        th = threading.current_thread()
        self._spans.append(SpanEvent(
            name=name, cat=cat, t0=t0, t1=t1, tid=th.ident or 0,
            thread=th.name, track=track, clock=clock, args=args))

    def add(self, name: str, delta: float, *, track: Optional[str] = None,
            t: Optional[float] = None, clock: str = "wall") -> None:
        """Cumulative counter (e.g. wire bytes): records the running total
        so the exported track is monotone and ``total(name)`` is exact."""
        if not self.enabled:
            return
        with self._lock:
            value = self._totals.get(name, 0.0) + delta
            self._totals[name] = value
        self._counters.append(CounterEvent(
            name=name, t=time.perf_counter() if t is None else t,
            value=value, track=track, clock=clock))

    def gauge(self, name: str, value: float, *, track: Optional[str] = None,
              t: Optional[float] = None, clock: str = "wall") -> None:
        """Instantaneous counter (e.g. queue depth, cache hit rate)."""
        if not self.enabled:
            return
        self._counters.append(CounterEvent(
            name=name, t=time.perf_counter() if t is None else t,
            value=float(value), track=track, clock=clock))

    def collective(self, kind: str, cluster_bytes: int, *,
                   wire_bytes: Optional[int] = None, layer: int = 0,
                   program: str = "sync", forward: int = 0) -> None:
        """Record one collective op (called by the sync strategies each
        time a forward pass runs one; sizes are per device, times k)."""
        if not self.enabled:
            return
        self._collectives.append(CollectiveEvent(
            kind=kind, cluster_bytes=int(cluster_bytes),
            wire_bytes=None if wire_bytes is None else int(wire_bytes),
            layer=layer, program=program, forward=forward))

    # -- reading ------------------------------------------------------------

    def spans(self, name: Optional[str] = None) -> List[SpanEvent]:
        evs = list(self._spans)
        return evs if name is None else [e for e in evs if e.name == name]

    def counters(self, name: Optional[str] = None) -> List[CounterEvent]:
        evs = list(self._counters)
        return evs if name is None else [e for e in evs if e.name == name]

    def collectives(self, program: Optional[str] = None
                    ) -> List[CollectiveEvent]:
        evs = list(self._collectives)
        if program is None:
            return evs
        return [e for e in evs if e.program == program]

    def total(self, name: str) -> Optional[float]:
        """Exact cumulative total for an ``add`` counter (``None`` if the
        counter never fired — distinguishes "measured zero" from "not
        instrumented / tracing was off")."""
        with self._lock:
            return self._totals.get(name)

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)

    def __len__(self) -> int:
        return len(self._spans) + len(self._counters) + len(self._collectives)

    def clear(self) -> None:
        self._spans.clear()
        self._counters.clear()
        self._collectives.clear()
        with self._lock:
            self._totals.clear()


# -- module-level singleton -------------------------------------------------

_NULL = Tracer(enabled=False, capacity=1)
_current: Tracer = _NULL


def get_tracer() -> Tracer:
    """The installed tracer (the disabled no-op singleton by default)."""
    return _current


def install(tracer: Tracer) -> Tracer:
    """Install ``tracer`` as the process-wide sink; returns it."""
    global _current
    _current = tracer
    return tracer


def uninstall() -> None:
    """Restore the disabled no-op singleton."""
    global _current
    _current = _NULL


@contextmanager
def tracing(capacity: int = _DEFAULT_CAPACITY) -> Iterator[Tracer]:
    """Install a fresh enabled tracer for the block; restore on exit."""
    prev = _current
    tr = install(Tracer(enabled=True, capacity=capacity))
    try:
        yield tr
    finally:
        install(prev)


def traced(name: Optional[str] = None, *, cat: str = "fn",
           track: Optional[str] = None) -> Callable:
    """Decorator API: run the wrapped call under a span. Resolves the
    tracer at call time, so functions decorated at import time respect a
    later ``install()``."""
    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            with get_tracer().span(label, cat=cat, track=track):
                return fn(*a, **kw)
        return wrapper
    return deco

"""Deterministic fault plans: what breaks, where, and when.

Twin of repro/fault/plan.py, tracer calls included.

A `FaultPlan` is a seeded, declarative list of faults to inject into a run
— the chaos-engineering twin of the study grids: every fault is addressed
by the SAME coordinates the deterministic execution uses (step index,
worker id, virtual arrival time), so a faulted run is exactly reproducible
and a retried/resumed run can be held bitwise against the unfaulted oracle.

Spec grammar (the `--inject-fault` CLI argument, repeatable)::

    kind@key:value[,key:value...]

    crash@step:3              kill the run at training step 3
    sample-error@step:2,worker:1   transient sampler exception (retried)
    fetch-error@step:4,worker:0    transient feature-fetch exception
    straggler@step:1,worker:2,delay:0.05   slow worker (seconds)
    corrupt-ckpt              corrupt the newest checkpoint before resume
    worker-death@t:0.5,worker:1    serving worker dies at virtual time t
    worker-loss@epoch:2,worker:1   elastic: shrink k -> k-1 at epoch 2
    worker-join@epoch:4            elastic: grow back to the original k

An unknown kind (or malformed spec) raises `FaultSpecError` whose message
lists the valid kinds — the CLIs turn that into an exit-1 diagnosis.

Every injection and every successful handling is recorded in the tracer
(obs/trace.py: `fault.injected` / `fault.handled` counters plus a
`fault.inject` span per event), and the plan keeps its own authoritative
counts — the reconciliation gate (obs/reconcile.reconcile_recovery) holds
the two stories against each other EXACTLY.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Iterable, List, Optional

import numpy as np

from repro_torch.obs.trace import get_tracer

__all__ = ["FAULT_KINDS", "FaultEvent", "FaultPlan", "FaultSpecError",
           "parse_fault_spec"]

FAULT_KINDS = (
    "crash",          # fatal worker crash at a training step
    "sample-error",   # transient sampler exception (retry-recoverable)
    "fetch-error",    # transient feature/embedding fetch exception
    "straggler",      # slow worker: injected host delay
    "corrupt-ckpt",   # corrupted/partial newest checkpoint directory
    "worker-death",   # serving worker dies at virtual time t
    "worker-loss",    # elastic training: lose a worker at an epoch
    "worker-join",    # elastic training: a worker (re)joins at an epoch
)


class FaultSpecError(ValueError):
    """Malformed/unknown `--inject-fault` spec (message lists valid kinds)."""


@dataclasses.dataclass
class FaultEvent:
    """One scheduled fault. Unused coordinates stay at their sentinels;
    `worker=-1` means "let the seeded plan pick one" (resolve_worker)."""

    kind: str
    step: int = -1       # training step (crash/sample-error/fetch-error/straggler)
    epoch: int = -1      # epoch (worker-loss / worker-join)
    worker: int = -1     # worker id; -1 = seeded choice
    at: float = -1.0     # virtual time, seconds (worker-death)
    delay: float = 0.0   # injected host delay, seconds (straggler)

    def describe(self) -> str:
        parts = [self.kind]
        if self.step >= 0:
            parts.append(f"step={self.step}")
        if self.epoch >= 0:
            parts.append(f"epoch={self.epoch}")
        if self.worker >= 0:
            parts.append(f"worker={self.worker}")
        if self.at >= 0:
            parts.append(f"t={self.at:g}")
        if self.delay:
            parts.append(f"delay={self.delay:g}")
        return " ".join(parts)


_INT_KEYS = {"step": "step", "epoch": "epoch", "worker": "worker"}
_FLOAT_KEYS = {"t": "at", "at": "at", "delay": "delay"}


def parse_fault_spec(spec: str) -> FaultEvent:
    """Parse one `kind@key:value[,key:value...]` spec string."""
    kind, _, rest = spec.partition("@")
    kind = kind.strip()
    if kind not in FAULT_KINDS:
        raise FaultSpecError(
            f"unknown fault kind {kind!r} in spec {spec!r}; "
            f"valid kinds: {', '.join(FAULT_KINDS)}")
    ev = FaultEvent(kind=kind)
    if not rest:
        return ev
    for part in rest.split(","):
        key, sep, val = part.partition(":")
        key = key.strip()
        if not sep or not val:
            raise FaultSpecError(
                f"malformed parameter {part!r} in spec {spec!r} "
                f"(expected key:value); valid kinds: {', '.join(FAULT_KINDS)}")
        try:
            if key in _INT_KEYS:
                setattr(ev, _INT_KEYS[key], int(val))
            elif key in _FLOAT_KEYS:
                setattr(ev, _FLOAT_KEYS[key], float(val))
            else:
                raise FaultSpecError(
                    f"unknown parameter {key!r} in spec {spec!r}; valid "
                    f"parameters: step, epoch, worker, t, delay")
        except ValueError as e:
            if isinstance(e, FaultSpecError):
                raise
            raise FaultSpecError(
                f"non-numeric value {val!r} for {key!r} in spec {spec!r}"
            ) from e
    return ev


class FaultPlan:
    """A seeded set of `FaultEvent`s with fire-once semantics.

    Thread-safe: the pipeline's producer/sampler threads probe the plan
    concurrently; each event fires exactly once (`fire` is check-and-set
    under one lock). `injected_count`/`handled_count` are the plan's own
    books.
    """

    def __init__(self, events: Iterable[FaultEvent], seed: int = 0) -> None:
        self.events: List[FaultEvent] = list(events)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._fired: set = set()
        self._handled: set = set()
        self._resolved_workers: dict = {}

    @classmethod
    def parse(cls, specs: Iterable[str], seed: int = 0) -> "FaultPlan":
        return cls([parse_fault_spec(s) for s in specs], seed=seed)

    # ------------------------------------------------------------- queries
    def pending(self, kind: str, *, step: Optional[int] = None,
                epoch: Optional[int] = None,
                worker: Optional[int] = None) -> List[FaultEvent]:
        """Unfired events of `kind` matching the given coordinates. A
        coordinate the event left unspecified (-1) matches anything."""
        out = []
        with self._lock:
            for i, ev in enumerate(self.events):
                if ev.kind != kind or i in self._fired:
                    continue
                if step is not None and ev.step >= 0 and ev.step != step:
                    continue
                if epoch is not None and ev.epoch >= 0 and ev.epoch != epoch:
                    continue
                if worker is not None and ev.worker >= 0 and ev.worker != worker:
                    continue
                out.append(ev)
        return out

    def events_of(self, kind: str) -> List[FaultEvent]:
        return [ev for ev in self.events if ev.kind == kind]

    def resolve_worker(self, ev: FaultEvent, k: int) -> int:
        """The event's worker id, drawing one deterministically from the
        plan seed when the spec left it open (stable across calls)."""
        if ev.worker >= 0:
            return ev.worker
        idx = self.events.index(ev)
        with self._lock:
            if idx not in self._resolved_workers:
                rng = np.random.default_rng((self.seed, idx))
                self._resolved_workers[idx] = int(rng.integers(0, k))
        return self._resolved_workers[idx]

    # ------------------------------------------------------------ recording
    def fire(self, ev: FaultEvent, **ctx) -> bool:
        """Mark `ev` injected (once); False if it already fired. Records the
        `fault.injected` counter and a `fault.inject` span, whose args are
        the event and `ctx` (the coordinates it fired at)."""
        idx = self.events.index(ev)
        with self._lock:
            if idx in self._fired:
                return False
            self._fired.add(idx)
        tracer = get_tracer()
        if tracer.enabled:
            now = time.perf_counter()
            args = {"kind": ev.kind, "event": ev.describe()}
            args.update({k: v for k, v in ctx.items()})
            tracer.record_span("fault.inject", now, now, cat="fault",
                               args=args)
        tracer.add("fault.injected", 1)
        return True

    def mark_handled(self, ev: FaultEvent) -> bool:
        """Mark a fired event as successfully handled (retry succeeded,
        delay absorbed, failover completed, checkpoint fallback worked)."""
        idx = self.events.index(ev)
        with self._lock:
            if idx not in self._fired or idx in self._handled:
                return False
            self._handled.add(idx)
        get_tracer().add("fault.handled", 1)
        return True

    # ------------------------------------------------------------- accounts
    @property
    def injected_count(self) -> int:
        with self._lock:
            return len(self._fired)

    @property
    def handled_count(self) -> int:
        with self._lock:
            return len(self._handled)

    def fired_events(self) -> List[FaultEvent]:
        with self._lock:
            return [self.events[i] for i in sorted(self._fired)]

    def __len__(self) -> int:
        return len(self.events)

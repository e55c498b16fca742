"""Fault injection hooks + retry-with-backoff for the host phases.

Twin of repro/fault/inject.py; under an installed tracer (obs/trace.py)
`retry_call` counts `fault.retries` and records a `fault.retry.<phase>`
span per failed attempt.

The injector is the bridge between a declarative `FaultPlan` and the
execution seams the plan addresses:

  * `at_step`    — the pipeline's step entry (`BatchPreparer.prepare`, and
                   the full-batch epoch loop): fatal `crash` events raise
                   `WorkerCrash`, which in overlap mode travels through the
                   producer's poison token to the consumer.
  * `on_sample`  — per-(step, worker) sampling: `straggler` events sleep
                   (delay absorbed, handled on the spot); `sample-error`
                   events raise a retryable `TransientSampleFault`.
  * `on_fetch`   — per-(step, worker) feature gather: `fetch-error` events
                   raise a retryable `TransientFetchFault`.
  * `RowStore.gather` additionally consults the module-level fetch hook
    (`install_fetch_hook`) — the generic seam for paths that don't thread
    an injector (serving, ad-hoc gathers); exceptions raised there are
    caught by the same caller-side retry.

`retry_call` is the recovery half: bounded attempts with exponential
backoff under a per-phase deadline. A retried phase re-derives its RNG from
the (step, worker) `SeedSequence`, so the retried batch is bitwise-
identical to the first attempt (pinned in tests/test_torch_fault.py).
Transient exceptions carry their plan + event; `retry_call` marks them
handled on the first subsequent success, keeping the plan's books exact.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Callable, Optional

from repro_torch.obs.trace import get_tracer

__all__ = ["FaultEscalation", "FaultInjector", "InjectedFault",
           "TransientFault", "TransientFetchFault", "TransientSampleFault",
           "WorkerCrash", "corrupt_latest_checkpoint", "install_fetch_hook",
           "clear_fetch_hook", "fetch_hook", "retry_call"]


class InjectedFault(RuntimeError):
    """Base class for every injected failure (carries its plan + event)."""

    def __init__(self, message: str, *, event=None, plan=None) -> None:
        super().__init__(message)
        self.event = event
        self.plan = plan


class WorkerCrash(InjectedFault):
    """Fatal: the worker process is gone. Not retryable — recovery is
    checkpoint restore (--resume) or elastic shrink."""


class TransientFault(InjectedFault):
    """Retryable: the next attempt of the same phase may succeed."""


class TransientSampleFault(TransientFault):
    """Transient sampler failure (remote adjacency RPC dropped)."""


class TransientFetchFault(TransientFault):
    """Transient feature/embedding fetch failure (store RPC dropped)."""


class FaultEscalation(RuntimeError):
    """A retried phase exhausted its attempts/deadline — now fatal."""


# ---------------------------------------------------------------------------
# generic RowStore.gather seam (module-level so stores need no plumbing)
# ---------------------------------------------------------------------------

_FETCH_HOOK: Optional[Callable] = None


def install_fetch_hook(fn: Callable) -> None:
    """Install `fn(worker, ids)` to run at the top of every
    `RowStore.gather`; it may raise a `TransientFetchFault`."""
    global _FETCH_HOOK
    _FETCH_HOOK = fn


def clear_fetch_hook() -> None:
    global _FETCH_HOOK
    _FETCH_HOOK = None


def fetch_hook() -> Optional[Callable]:
    return _FETCH_HOOK


# ---------------------------------------------------------------------------
# the injector
# ---------------------------------------------------------------------------


class FaultInjector:
    """Probes a `FaultPlan` at the execution seams (see module docstring).

    `k` (the worker count) lets events with an unspecified worker resolve
    to a seeded choice; the `BatchPreparer` sets it on first use when the
    caller didn't."""

    def __init__(self, plan, k: Optional[int] = None) -> None:
        self.plan = plan
        self.k = k

    def _worker_of(self, ev) -> int:
        if ev.worker >= 0 or self.k is None:
            return ev.worker
        return self.plan.resolve_worker(ev, self.k)

    # ------------------------------------------------------------ step seam
    def at_step(self, step: int) -> None:
        """Raise `WorkerCrash` if a crash is scheduled for this step."""
        for ev in self.plan.pending("crash", step=step):
            if self.plan.fire(ev, step=step):
                raise WorkerCrash(
                    f"injected worker crash at step {step}",
                    event=ev, plan=self.plan)

    def at_epoch(self, epoch: int) -> None:
        """Epoch-addressed alias of `at_step` for the full-batch loop (one
        step per epoch: `crash@step:N` means epoch N there)."""
        self.at_step(epoch)

    # -------------------------------------------------------- sampling seam
    def on_sample(self, step: int, worker: int) -> None:
        for ev in self.plan.pending("straggler", step=step, worker=worker):
            if self._worker_of(ev) not in (-1, worker):
                continue
            if self.plan.fire(ev, step=step, worker=worker):
                time.sleep(max(ev.delay, 0.0))
                self.plan.mark_handled(ev)  # the delay IS the fault, absorbed
        for ev in self.plan.pending("sample-error", step=step, worker=worker):
            if self._worker_of(ev) not in (-1, worker):
                continue
            if self.plan.fire(ev, step=step, worker=worker):
                raise TransientSampleFault(
                    f"injected sampler fault at step {step} worker {worker}",
                    event=ev, plan=self.plan)

    # ----------------------------------------------------------- fetch seam
    def on_fetch(self, step: int, worker: int) -> None:
        for ev in self.plan.pending("fetch-error", step=step, worker=worker):
            if self._worker_of(ev) not in (-1, worker):
                continue
            if self.plan.fire(ev, step=step, worker=worker):
                raise TransientFetchFault(
                    f"injected fetch fault at step {step} worker {worker}",
                    event=ev, plan=self.plan)

    def gather_hook(self) -> Callable:
        """A `(worker, ids)` closure for `install_fetch_hook` that fires
        this plan's step-agnostic fetch-error events at the store seam."""

        def hook(worker: int, ids) -> None:
            for ev in self.plan.pending("fetch-error", worker=worker):
                if ev.step >= 0:  # step-addressed events belong to on_fetch
                    continue
                if self.plan.fire(ev, worker=int(worker)):
                    raise TransientFetchFault(
                        f"injected fetch fault at gather (worker {worker})",
                        event=ev, plan=self.plan)

        return hook


# ---------------------------------------------------------------------------
# retry-with-backoff
# ---------------------------------------------------------------------------


def retry_call(fn: Callable, *, phase: str, attempts: int = 3,
               backoff: float = 0.005, timeout: float = 5.0):
    """Run `fn()` retrying `TransientFault`s: exponential backoff, at most
    `attempts` tries, all within a `timeout`-second phase deadline.

    Deterministic contract: `fn` must re-derive any randomness from its
    own (step, worker) SeedSequence so attempt N is bitwise attempt 1.
    On the first success after failures, every distinct fault retried is
    marked handled on its plan; exhausting the budget raises
    `FaultEscalation` chained to the last fault.
    """
    tracer = get_tracer()
    t_start = time.perf_counter()
    delay = backoff
    seen = []
    while True:
        t_attempt = time.perf_counter() if tracer.enabled else 0.0
        try:
            out = fn()
        except TransientFault as e:
            seen.append(e)
            tracer.add("fault.retries", 1)
            if tracer.enabled:
                tracer.record_span(
                    f"fault.retry.{phase}", t_attempt, time.perf_counter(),
                    cat="fault", args={"attempt": len(seen),
                                       "error": str(e)})
            elapsed = time.perf_counter() - t_start
            if len(seen) >= attempts or elapsed + delay > timeout:
                raise FaultEscalation(
                    f"phase {phase!r} still failing after {len(seen)} "
                    f"attempt(s) in {elapsed:.3f}s (attempts={attempts}, "
                    f"timeout={timeout:g}s)") from e
            time.sleep(delay)
            delay *= 2
            continue
        for e in seen:
            if e.plan is not None and e.event is not None:
                e.plan.mark_handled(e.event)
        return out


# ---------------------------------------------------------------------------
# checkpoint corruption (the corrupt-ckpt fault)
# ---------------------------------------------------------------------------


def corrupt_latest_checkpoint(directory: str, mode: str = "manifest") -> Optional[str]:
    """Corrupt the NEWEST complete checkpoint under `directory`.

    mode="manifest": delete its manifest.json (the half-written-directory
    signature — restore must skip it and fall back to the previous one).
    mode="truncate": truncate its first leaf file (np.load then fails).
    Returns the corrupted path, or None if there was nothing to corrupt.
    """
    from repro_torch.ckpt.checkpoint import _complete_checkpoints

    ckpts = _complete_checkpoints(directory)
    if not ckpts:
        return None
    _, path = ckpts[-1]
    if mode == "manifest":
        os.remove(os.path.join(path, "manifest.json"))
    elif mode == "truncate":
        leaves = sorted(n for n in os.listdir(path) if n.endswith(".npy"))
        if not leaves:
            shutil.rmtree(path)
        else:
            with open(os.path.join(path, leaves[0]), "wb") as fh:
                fh.write(b"\x00")
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return path

"""The rule registry: distributed-training invariants checked per program.

The counterpart of repro/analysis/rules.py, with its rule names, `Finding`
and `Report` (schema "gnn-lint-report/v1"). Every rule is a function
`(Program) -> list[Finding]` registered under a stable name. `run_rules`
drives the cross product (each rule decides applicability from the
program's kind/fields and returns [] when it does not apply); a rule that
raises is converted into an error finding rather than crashing the gate,
so a broken rule can never silently pass a PR.

The five core rules:

  no-scatter         recorded programs of scatter-free cells dispatch no
                     data-dependent accumulate (`kernels.ops.
                     SCATTER_PRIMITIVES`: on the card these add in atomic
                     order), and anchor cells MUST (a blind recorder is
                     itself a violation)
  dtype-policy       the only narrowing converts from >=f32 a recorded
                     program may contain are the wire codec's declared
                     wire dtypes (`core.wire.narrow_wire_dtypes`)
  collective-budget  the collectives a sync aggregate records equal the
                     analytic prediction (`gnn.sync.collective_budget`):
                     each kind's count in range, its cluster bytes exact,
                     no unbudgeted kinds
  donation           after a step, none of the step before's carries
                     (params, Adam state, EF carry) is still alive: what
                     `donate_argnums` buys the reference on the device
  retrace-guard      driving a warmed program sweep builds or loads at most
                     its budget of kernel libraries (kernels/_build.py's
                     counter: the port's only compile)
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time
import weakref
from collections import Counter
from typing import Callable, Iterable, Optional

from repro_torch.analysis.dispatch import (
    count_primitives,
    narrowing_converts,
    primitive_names,
)
from repro_torch.analysis.programs import Program

__all__ = [
    "Finding", "Report", "RULES", "register_rule", "run_rules",
    "count_builds", "check_scatter", "check_narrowing", "check_budget",
    "check_donation",
]

LEVELS = ("error", "warn", "info")


@dataclasses.dataclass
class Finding:
    rule: str
    program: str
    level: str                    # error | warn | info
    message: str
    data: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Report:
    findings: list
    programs_run: list
    rules_run: list
    elapsed_s: float = 0.0

    @property
    def errors(self) -> list:
        return [f for f in self.findings if f.level == "error"]

    @property
    def exit_code(self) -> int:
        return 1 if self.errors else 0

    def to_dict(self) -> dict:
        counts = {lv: 0 for lv in LEVELS}
        for f in self.findings:
            counts[f.level] = counts.get(f.level, 0) + 1
        return {
            "schema": "gnn-lint-report/v1",
            "programs": self.programs_run,
            "rules": self.rules_run,
            "counts": counts,
            "exit_code": self.exit_code,
            "elapsed_s": round(self.elapsed_s, 3),
            "findings": [f.to_dict() for f in self.findings],
        }


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    fn: Callable[[Program], list]


RULES: dict = {}


def register_rule(name: str, doc: str):
    def deco(fn):
        RULES[name] = Rule(name=name, doc=doc, fn=fn)
        return fn

    return deco


def run_rules(programs: Iterable[Program],
              rules: Optional[Iterable[str]] = None) -> Report:
    """Run the selected rules (default: all) over the programs."""
    selected = [RULES[n] for n in (rules or sorted(RULES))]
    programs = list(programs)
    t0 = time.perf_counter()
    findings: list = []
    for prog in programs:
        for rule in selected:
            try:
                findings.extend(rule.fn(prog))
            except Exception as exc:  # a crashed rule must fail the gate
                findings.append(Finding(
                    rule=rule.name, program=prog.name, level="error",
                    message=f"rule crashed: {type(exc).__name__}: {exc}",
                ))
    return Report(
        findings=findings,
        programs_run=[p.name for p in programs],
        rules_run=[r.name for r in selected],
        elapsed_s=time.perf_counter() - t0,
    )


# ---------------------------------------------------------------------------
# Shared check helpers (also the API the tests call directly)
# ---------------------------------------------------------------------------


def check_scatter(traces: Iterable, expect_free: bool) -> Optional[str]:
    """None when the recorded programs match the expectation, else the
    violation message. `expect_free=False` is the anchor direction: the
    recorder must SEE the scatter oracle's accumulates."""
    from repro_torch.kernels.ops import SCATTER_PRIMITIVES

    found: set = set()
    for ops in traces:
        found |= primitive_names(ops) & set(SCATTER_PRIMITIVES)
    if expect_free and found:
        return f"scatter ops in a scatter-free cell: {sorted(found)}"
    if not expect_free and not found:
        return ("anchor cell recorded clean — the op recorder is blind "
                f"(expected one of {list(SCATTER_PRIMITIVES)})")
    return None


def check_narrowing(traces: Iterable, codec) -> list:
    """Narrowing converts (>=4-byte float source -> strictly smaller dtype)
    not licensed by the codec's wire dtypes. Returns [(src, dst, count)]."""
    from repro_torch.core.wire import narrow_wire_dtypes

    allowed = set(narrow_wire_dtypes(codec)) | {"bool"}
    bad: list = []
    for ops in traces:
        for (src, dst), n in narrowing_converts(ops).items():
            if dst not in allowed:
                bad.append((src, dst, n))
    return bad


def check_budget(recorded: Iterable, budget: dict) -> list:
    """Hold recorded collectives (`obs.trace.CollectiveEvent`s, cluster
    bytes each) to a `collective_budget` prediction. Returns violation
    messages (empty = every kind's op count is in range and its bytes
    EXACTLY the analytic cluster bytes)."""
    count: Counter = Counter()
    nbytes: Counter = Counter()
    for ev in recorded:
        count[ev.kind] += 1
        nbytes[ev.kind] += ev.cluster_bytes
    problems: list = []
    for kind, want in budget.items():
        lo, hi = want["count"]
        if not lo <= count[kind] <= hi:
            problems.append(f"{kind}: {count[kind]} ops, budget [{lo}, {hi}]")
        if nbytes[kind] != want["cluster_bytes"]:
            problems.append(f"{kind}: {nbytes[kind]} cluster bytes, budget "
                            f"{want['cluster_bytes']}")
    extra = sorted(set(count) - set(budget))
    if extra:
        problems.append(f"unbudgeted collective kinds recorded: {extra}")
    return problems


def check_donation(step: Callable[[], object],
                   carries: Callable[[], dict]) -> list:
    """Names of the carries a step left alive: step once (the lossy
    trainers make their EF carry there), take a weak reference to every
    carry, step again, collect. A tensor's Python object lives as long as
    anything holds its storage's owner (autograd graphs included), so a
    live reference is memory the device still holds."""
    step()
    refs = {name: weakref.ref(t) for name, t in carries().items()}
    step()
    gc.collect()
    return sorted(name for name, ref in refs.items() if ref() is not None)


# ---------------------------------------------------------------------------
# Build counting (retrace-guard)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def count_builds():
    """Counts kernel builds (nvcc runs) and library loads inside the block
    (kernels/_build.py `BUILDS`): `box.count` after. The twin of the
    reference's `count_compiles`."""
    from repro_torch.kernels import _build

    class _Box:
        count = 0

    box = _Box()
    start = sum(_build.BUILDS.values())
    try:
        yield box
    finally:
        box.count = sum(_build.BUILDS.values()) - start


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------


def _kernel_launches(traces) -> dict:
    counts: Counter = Counter()
    for ops in traces:
        counts.update({name: n for name, n in count_primitives(ops).items()
                       if name.startswith("kernel:")})
    return dict(counts)


@register_rule(
    "no-scatter",
    "scatter-free cells record no index_add_/scatter_reduce_-style "
    "accumulate; anchor cells must still trip the recorder")
def _rule_no_scatter(prog: Program) -> list:
    if prog.kind != "ops" or prog.expect_scatter_free is None:
        return []
    if prog.skip is not None:
        return [Finding("no-scatter", prog.name, "info",
                        f"skipped: {prog.skip}")]
    traces = prog.artifact()
    data = {"kernel_launches": _kernel_launches(traces)}
    msg = check_scatter(traces, prog.expect_scatter_free)
    if msg is not None:
        return [Finding("no-scatter", prog.name, "error", msg, data=data)]
    return [Finding("no-scatter", prog.name, "info",
                    "scatter-free" if prog.expect_scatter_free
                    else "anchor: scatter seen as expected", data=data)]


@register_rule(
    "dtype-policy",
    "the only narrowing converts from fp32+ are the wire codec's declared "
    "wire dtypes")
def _rule_dtype_policy(prog: Program) -> list:
    if prog.kind != "ops" or prog.codec is None or prog.skip is not None:
        return []
    bad = check_narrowing(prog.artifact(), prog.codec)
    if bad:
        detail = ", ".join(f"{s}->{d} x{n}" for s, d, n in bad)
        return [Finding(
            "dtype-policy", prog.name, "error",
            f"narrowing converts outside codec {prog.codec!r}: {detail}",
            data={"converts": [list(b) for b in bad]})]
    return [Finding("dtype-policy", prog.name, "info",
                    f"narrowing converts all licensed by {prog.codec!r}")]


@register_rule(
    "collective-budget",
    "recorded collective op counts and cluster bytes equal the analytic "
    "collective_budget prediction, no unbudgeted kinds")
def _rule_collective_budget(prog: Program) -> list:
    if prog.kind != "collectives" or prog.budget is None:
        return []
    problems = check_budget(prog.make(), prog.budget())
    if problems:
        return [Finding("collective-budget", prog.name, "error", p)
                for p in problems]
    return [Finding("collective-budget", prog.name, "info",
                    "recorded collectives match the analytic budget exactly")]


@register_rule(
    "donation",
    "after a step none of the step before's carries (params, Adam state, "
    "EF carry) is alive: the device memory donation would free")
def _rule_donation(prog: Program) -> list:
    if prog.kind != "donation":
        return []
    alive = check_donation(*prog.make())
    if alive:
        return [Finding(
            "donation", prog.name, "error",
            f"{len(alive)} carries of the step before are still alive "
            f"after a step: {alive[:8]}",
            data={"alive": alive})]
    return [Finding("donation", prog.name, "info",
                    "every carry of the step before was freed")]


@register_rule(
    "retrace-guard",
    "a pre-warmed sweep builds or loads at most its budget of kernel "
    "libraries — new shapes and codec tiers build nothing")
def _rule_retrace_guard(prog: Program) -> list:
    if prog.kind != "retrace" or prog.sweep is None:
        return []
    # warm: the first run builds and loads what the sweep's kernels need.
    # A sweep may return a callable hot loop — then only the loop (steps/
    # answers) is measured and per-sweep setup stays outside the window.
    hot = prog.sweep()
    if callable(hot):
        hot()
        hot = prog.sweep()
        with count_builds() as box:
            hot()
    else:
        with count_builds() as box:
            prog.sweep()
    data = {"builds": box.count, "budget": prog.retrace_budget}
    if box.count > prog.retrace_budget:
        return [Finding(
            "retrace-guard", prog.name, "error",
            f"{box.count} kernel builds/loads in a warmed sweep, budget "
            f"{prog.retrace_budget} — a shape-dependent build crept into "
            "this entry point", data=data)]
    return [Finding(
        "retrace-guard", prog.name, "info",
        f"{box.count} builds <= budget {prog.retrace_budget}", data=data)]

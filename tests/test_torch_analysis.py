"""The port's static-analysis gate (`repro_torch.analysis`, `gnn_lint`)
against the JAX package's, on the CPU.

  (a) twins of tests/test_analysis.py's recorder / walker, check-helper,
      retrace-guard and dead-export tests, on recorded aten ops
  (b) across the packages: the port's grid has the reference's program
      names (less `donation/jit-probe`: no jit to donate to) and the
      reference's off-TPU scatter expectations (less the `pallas` cells,
      skipped on the CPU); every full-batch cell's narrowing (src, dst)
      pairs equal those in the reference's jaxpr, read by a small walker
      over `eqn.params` here (`repro.analysis.jaxpr` is blind on this JAX)
  (c) recording observes and never perturbs: a recorded loss is the
      unrecorded one bit for bit
  (d) every rule's seeded violation turns the gate red; the CLI's exit
      codes, report schema and grids, run in subprocesses (each with a
      time limit)
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import programs as j_programs  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    OpRecorder,
    Program,
    build_programs,
    check_budget,
    check_narrowing,
    check_scatter,
    convert_ops,
    count_builds,
    count_primitives,
    narrowing_converts,
    primitive_names,
    record,
    run_rules,
    violation_program,
)
from repro_torch.analysis import programs as t_programs  # noqa: E402
from repro_torch.analysis.deadcode import (  # noqa: E402
    collect_exports,
    dead_exports,
    reference_counts,
)
from repro_torch.gnn.minibatch import repeatable_step  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ops import scatter_free_traced  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RULE_NAMES = ("no-scatter", "dtype-policy", "collective-budget", "donation",
              "retrace-guard")
NOT_PORTED = {"donation/jit-probe"}
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# the op recorder and its helpers
# ---------------------------------------------------------------------------


def test_recorder_sees_inside_autograd_function():
    """Ops inside an autograd.Function's forward, and in nested calls, are
    recorded: dispatch is below autograd, so nothing needs recursing."""

    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return torch.sin(x) * 2.0

        @staticmethod
        def backward(ctx, g):
            return g

    def inner(y):
        return torch.cos(y)

    def fn(x):
        return Fn.apply(inner(x))

    ops = record(fn, torch.ones(4, requires_grad=True))
    names = primitive_names(ops)
    assert {"aten.sin", "aten.cos", "aten.mul"} <= names
    counts = count_primitives(ops)
    assert counts["aten.sin"] == 1 and counts["aten.cos"] == 1
    assert len(ops) == sum(counts.values())


def test_convert_walker_and_narrowing_filter():
    def fn(x, idx):
        wire = x.to(torch.bfloat16).to(torch.float32)   # narrowing
        small = idx.to(torch.int8)                      # integer churn
        bits = x.view(torch.int32)                      # a bitcast
        return wire.sum() + small.sum() + bits.sum()

    ops = record(fn, torch.ones(8), torch.arange(8, dtype=torch.int32))
    conv = convert_ops(ops)
    assert conv[("float32", "bfloat16")] == 1
    assert conv[("int32", "int8")] == 1
    assert ("float32", "int32") not in conv
    # only the float shrink is wire compression
    assert narrowing_converts(ops) == {("float32", "bfloat16"): 1}


def test_copy_into_a_narrower_buffer_is_a_convert():
    def fn(x):
        buf = torch.empty(8, dtype=torch.bfloat16)
        buf.copy_(x)
        return buf

    assert narrowing_converts(record(fn, torch.ones(8))) == {
        ("float32", "bfloat16"): 1}


def test_inference_mode_casts_are_recorded():
    """Under inference_mode `to` reaches the mode undecomposed."""
    with torch.inference_mode():
        ops = record(lambda x: x.to(torch.float16), torch.ones(4))
    assert narrowing_converts(ops) == {("float32", "float16"): 1}


def test_check_scatter_both_directions():
    idx = torch.arange(4)

    def scatters(x):
        return torch.zeros(16).index_add_(0, idx, x)

    def accumulate_put(x):
        return torch.zeros(16).index_put_((idx,), x, accumulate=True)

    def plain_put(x):
        # an `.at[].set`: not a data-dependent accumulate
        return torch.zeros(16).index_put_((idx,), x)

    def clean(x):
        return x * 2.0

    x = torch.ones(4)
    rec_scatter, rec_clean = record(scatters, x), record(clean, x)
    assert check_scatter([rec_clean], expect_free=True) is None
    assert check_scatter([record(plain_put, x)], expect_free=True) is None
    assert check_scatter([rec_scatter], expect_free=False) is None
    msg = check_scatter([rec_scatter], expect_free=True)
    assert msg and "index_add_" in msg
    msg = check_scatter([record(accumulate_put, x)], expect_free=True)
    assert msg and "index_put_:accumulate" in msg
    # anchor direction: a clean recording where a scatter was REQUIRED
    # means the recorder went blind
    assert check_scatter([rec_clean], expect_free=False) is not None


def test_check_narrowing_respects_codec_license():
    ops = record(lambda x: x.to(torch.bfloat16).to(torch.float32).sum(),
                 torch.ones(8))
    assert check_narrowing([ops], "bf16") == []
    assert check_narrowing([ops], "fp32") == [("float32", "bfloat16", 1)]


def test_check_budget_counts_bytes_and_kinds():
    from repro_torch.obs.trace import CollectiveEvent

    budget = {"all-to-all": {"count": (2, 2), "cluster_bytes": 96}}
    evs = [CollectiveEvent("all-to-all", 48), CollectiveEvent("all-to-all", 48)]
    assert check_budget(evs, budget) == []
    assert check_budget(evs[:1], budget) == [
        "all-to-all: 1 ops, budget [2, 2]",
        "all-to-all: 48 cluster bytes, budget 96"]
    extra = check_budget(evs + [CollectiveEvent("all-gather", 8)], budget)
    assert extra == ["unbudgeted collective kinds recorded: ['all-gather']"]


@pytest.mark.parametrize("backend,device,free", [
    ("scatter", "cpu", False), ("scatter", "cuda", False),
    ("tiled", "cpu", False), ("tiled", "cuda", True),
    ("pallas", "cpu", True), ("pallas", "cuda", True)])
def test_scatter_free_traced(backend, device, free):
    assert scatter_free_traced(backend, device) is free


# ---------------------------------------------------------------------------
# build counting (retrace-guard) and kernels/_build.py's counter
# ---------------------------------------------------------------------------


def test_build_counter_bumps_on_stubbed_build(tmp_path, monkeypatch):
    """`CudaLibrary.build` notes the nvcc run it makes (once: a second
    build finds the library), and `load` the library it loads."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        "if [ \"$1\" = --version ]; then echo 'stub nvcc'; exit 0; fi\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift\n"
        "done\n")
    fake.chmod(0o755)
    source = tmp_path / "stub.cu"
    source.write_text("// stub\n")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")

    class _Fn:
        pass

    class _Lib:                      # what `load` reads of a CDLL
        stub_error_string = _Fn()

    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: _Lib())
    lib = _build.CudaLibrary(str(source), "stub", lambda cdll: None)
    before = dict(_build.BUILDS)
    with count_builds() as box:
        path = lib.build()
        assert path.exists()
        lib.build()                  # already built: no nvcc run
        lib.load()
        lib.load()                   # already loaded
    assert box.count == 2
    assert _build.BUILDS[("stub", "build")] == before.get(("stub", "build"),
                                                          0) + 1
    assert _build.BUILDS[("stub", "load")] == before.get(("stub", "load"),
                                                         0) + 1


def test_retrace_guard_green_path():
    """A warmed, shape-stable hot loop builds nothing: budget 0 holds."""

    def sweep():
        def hot():
            torch.ones(4) * 2.0
            torch.ones(8) * 2.0
        return hot

    prog = Program(name="retrace/green", kind="retrace", sweep=sweep,
                   retrace_budget=0)
    report = run_rules([prog], ["retrace-guard"])
    assert report.exit_code == 0, [f.message for f in report.findings]


def test_retrace_guard_catches_shape_dependent_build():
    report = run_rules([violation_program("retrace-guard", CPU)],
                       ["retrace-guard"])
    assert report.exit_code == 1
    (err,) = report.errors
    assert "builds" in err.message and "budget" in err.message


# ---------------------------------------------------------------------------
# dead-export sweep
# ---------------------------------------------------------------------------


def _fake_repo(tmp_path):
    pkg = tmp_path / "src" / "repro_torch"
    pkg.mkdir(parents=True)
    (pkg / "mod.py").write_text(
        "def used():\n    return 1\n\n"
        "def unused():\n    return 2\n\n"
        "def kept():  # lint: keep\n    return 3\n\n"
        "def _private():\n    return 4\n\n"
        "CONST = 7\n"
    )
    tests = tmp_path / "tests"
    tests.mkdir()
    (tests / "test_torch_mod.py").write_text(
        "from repro_torch.mod import used\n\n"
        "def test_u():\n    assert used() == 1\n"
    )
    # the reference's sources and tests do not count as uses
    ref = tmp_path / "src" / "repro"
    ref.mkdir()
    (ref / "mod.py").write_text("def unused():\n    return CONST\n")
    (tests / "test_mod.py").write_text("from repro.mod import unused\n")
    return tmp_path


def test_dead_exports_flags_only_unreferenced_public(tmp_path):
    root = _fake_repo(tmp_path)
    exports = collect_exports(root)
    assert set(exports) == {"used", "unused", "CONST"}  # kept/_private skipped
    dead = dict(dead_exports(root))
    assert set(dead) == {"unused", "CONST"}


def test_reference_counts_are_token_matches(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("run_rules = 1\nrerun = 2\n")
    counts = reference_counts(["run"], [f])
    assert counts["run"] == 0  # substrings of other identifiers don't count


def test_port_has_no_unannotated_dead_exports():
    """The advisory sweep stays clean on the port itself — new dead exports
    must be deleted or `# lint: keep`-annotated."""
    assert dead_exports(ROOT) == []


# ---------------------------------------------------------------------------
# the grid against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", ["tiny", "smoke"])
def test_grid_names_and_expectations_match_reference(grid):
    ref = {p.name: p for p in j_programs.build_programs(grid)}
    port = build_programs(grid, device="cpu")
    assert [p.name for p in port] == [n for n in ref if n not in NOT_PORTED]
    kinds = {"jaxpr": "ops", "hlo": "collectives", "donation": "donation",
             "retrace": "retrace"}
    for p in port:
        r = ref[p.name]
        assert p.kind == kinds[r.kind], p.name
        if p.kind != "ops":
            continue
        assert p.codec == r.codec, p.name
        if p.meta["backend"] == "pallas":
            assert p.skip is not None and "needs the card" in p.skip, p.name
        else:
            assert p.skip is None, p.name
            assert p.expect_scatter_free == r.expect_scatter_free, p.name


def _jaxpr_eqns(jaxpr):
    """Every equation of a (Closed)Jaxpr and of the sub-jaxprs in its
    equations' params, read by duck type (the JAX core classes moved)."""
    j = getattr(jaxpr, "jaxpr", jaxpr)
    for eqn in j.eqns:
        yield eqn
        for v in eqn.params.values():
            yield from _sub_eqns(v)


def _sub_eqns(v):
    if hasattr(v, "eqns") or hasattr(getattr(v, "jaxpr", None), "eqns"):
        yield from _jaxpr_eqns(v)
    elif isinstance(v, (tuple, list)):
        for x in v:
            yield from _sub_eqns(x)
    elif isinstance(v, dict):
        for x in v.values():
            yield from _sub_eqns(x)


def _jaxpr_narrowing(jaxprs) -> dict:
    out: dict = {}
    for cj in jaxprs:
        for eqn in _jaxpr_eqns(cj):
            if eqn.primitive.name != "convert_element_type":
                continue
            src = np.dtype(eqn.invars[0].aval.dtype)
            dst = np.dtype(eqn.params["new_dtype"])
            if (np.issubdtype(src, np.floating) and src.itemsize >= 4
                    and dst.itemsize < src.itemsize):
                key = (src.name, dst.name)
                out[key] = out.get(key, 0) + 1
    return out


def test_fullbatch_narrowing_pairs_match_reference_jaxprs():
    """Every full-batch cell the CPU runs: the set of narrowing (src, dst)
    pairs the port records is the set in the reference's jaxpr (counts
    are printed, not compared)."""
    ref = {p.name: p for p in j_programs.build_programs("smoke")}
    cells = [p for p in build_programs("smoke", device="cpu")
             if p.name.startswith("fullbatch/") and p.skip is None]
    assert len(cells) == 17
    seen = set()
    for p in cells:
        got = {}
        for ops in p.artifact():
            for key, n in narrowing_converts(ops).items():
                got[key] = got.get(key, 0) + n
        want = _jaxpr_narrowing(ref[p.name].make())
        print(f"{p.name}: port {got}, reference {want}")
        assert set(got) == set(want), p.name
        seen |= set(got)
    assert seen == {("float32", "int8")}   # the int8 cells are not vacuous


def test_recording_changes_nothing():
    """A recorded forward is the unrecorded one bit for bit (values are
    never read by the recorder)."""
    from repro_torch.gnn.fullbatch import make_step_fns

    spec = t_programs._spec("gat", "tiled")
    _, blocks = t_programs._book_blocks("halo", True, t_programs.K, CPU)
    loss, forward = make_step_fns(spec, "halo", t_programs.K, codec="int8")
    params = t_programs._live_params(spec, CPU)
    with repeatable_step():
        plain = loss(params, blocks)
        with OpRecorder() as rec:
            recorded = loss(params, blocks)
        with torch.no_grad():
            logits = forward(params, blocks)
            with OpRecorder():
                logits_rec = forward(params, blocks)
        # the backward of a recorded forward too (as a step takes it: the
        # CPU gathers' backward adds in thread order outside the mode)
        g_plain = torch.autograd.grad(plain, params["layers"][0]["w"])[0]
        g_rec = torch.autograd.grad(recorded, params["layers"][0]["w"])[0]
    assert len(rec.ops) > 100
    assert torch.equal(plain, recorded)
    assert torch.equal(logits, logits_rec)
    assert torch.equal(g_plain, g_rec)


def test_collectives_cells_hold_their_budget_and_only_theirs():
    """The sim's recorded collectives meet `collective_budget` exactly, and
    the rule is not vacuous: the halo fp32 recording fails the int8
    budget (scale gathers missing, payload bytes 4x)."""
    progs = {p.name: p for p in build_programs("smoke", device="cpu")
             if p.kind == "collectives"}
    assert len(progs) == 5
    for p in progs.values():
        recorded = p.make()
        assert recorded, p.name
        assert check_budget(recorded, p.budget()) == [], p.name
    fp32 = progs["hlo/halo-fp32"].make()
    assert check_budget(fp32, progs["hlo/halo-int8"].budget())


# ---------------------------------------------------------------------------
# seeded violations and the donation rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_seeded_violation_turns_gate_red(rule):
    report = run_rules([violation_program(rule, CPU)])
    assert report.exit_code == 1
    assert {f.rule for f in report.errors} == {rule}
    # red for the violation, not for a crash of the rule
    assert not any("rule crashed" in f.message for f in report.errors)


def test_donation_frees_every_carry_of_a_lossy_step():
    """The rule's green direction on a real trainer, carries checked."""
    step, carries = t_programs._donation_fullbatch("int8", CPU)
    report = run_rules([Program(name="donation/check", kind="donation",
                                make=lambda: (step, carries))], ["donation"])
    assert report.exit_code == 0, [f.message for f in report.findings]
    names = set(carries())
    assert {"params[0]", "mu[0]", "nu[0]", "ef[0]", "step"} <= names


# ---------------------------------------------------------------------------
# gnn_lint CLI
# ---------------------------------------------------------------------------


def _lint(*argv, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gnn_lint", *argv],
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, cwd=ROOT,
    )


def test_cli_tiny_grid_green_and_report_schema(tmp_path):
    out = tmp_path / "report.json"
    proc = _lint("--grid", "tiny", "--device", "cpu", "--out-json", str(out))
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-1000:]
    report = json.loads(out.read_text())
    assert report["schema"] == "gnn-lint-report/v1"
    assert set(report) >= {"programs", "rules", "counts", "exit_code",
                           "elapsed_s", "findings"}
    assert report["exit_code"] == 0 and report["counts"]["error"] == 0
    assert set(report["rules"]) == set(RULE_NAMES)


@pytest.mark.parametrize("rule", RULE_NAMES)
def test_cli_seeded_violation_exits_1(rule):
    proc = _lint("--grid", "tiny", "--device", "cpu", "--inject-violation",
                 rule, "--out-json", "-")
    assert proc.returncode == 1, proc.stderr[-3000:]
    report = json.loads(proc.stdout[: proc.stdout.rindex("}") + 1])
    errs = [f for f in report["findings"] if f["level"] == "error"]
    assert errs and {f["rule"] for f in errs} == {rule}
    assert all(f["program"] == f"injected/{rule}" for f in errs)
    assert not any("rule crashed" in f["message"] for f in errs)


def test_cli_rejects_unknown_rule():
    proc = _lint("--rules", "no-such-rule")
    assert proc.returncode == 2
    assert "unknown rules" in proc.stderr


def test_cli_defaults_to_cuda_and_raises_without_it():
    proc = _lint("--grid", "tiny")
    assert proc.returncode != 0
    assert "no CUDA device is visible" in proc.stderr


def test_cli_smoke_grid_on_cpu(tmp_path):
    """The full gate on the CPU: green, the reference's program names less
    `donation/jit-probe`, every pallas cell one info skip; under 60 s."""
    out = tmp_path / "report.json"
    t0 = time.perf_counter()
    proc = _lint("--grid", "smoke", "--device", "cpu", "--out-json",
                 str(out), timeout=300)
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-1000:]
    assert seconds < 60, seconds
    report = json.loads(out.read_text())
    assert report["schema"] == "gnn-lint-report/v1"
    assert set(report["rules"]) == set(RULE_NAMES)
    ref = [p.name for p in j_programs.build_programs("smoke")]
    assert report["programs"] == [n for n in ref if n not in NOT_PORTED]
    pallas = [n for n in report["programs"] if "-pallas-" in n]
    assert len(pallas) == 6
    skips = [f for f in report["findings"]
             if f["message"].startswith("skipped: needs the card")]
    assert sorted(f["program"] for f in skips) == sorted(pallas)
    assert all(f["level"] == "info" for f in skips)
    # every rule met a program it applies to
    assert {f["rule"] for f in report["findings"]} == set(RULE_NAMES)

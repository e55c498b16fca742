"""The port's observability layer (`repro_torch.obs`, `gnn_trace`) against
the JAX package's, on the CPU.

  (a) twins of tests/test_obs.py's tracer, export and reconcile tests (all
      but the two that need `core/study.py`), on the port's trainers; the
      reference's "tracer installed after the step compiled" case has no
      compile here: its twin pins that a tracer installed after step 1
      records step 2's forward in full
  (b) across the packages: a timeline the port writes passes the
      reference's validator and the reference's loads through the port's
      `load_trace`; `reconcile_fullbatch` (halo and ring, fp32 and int8),
      `reconcile_minibatch` (fp32, int8), `reconcile_serving`,
      `reconcile_recovery` and the `gnn_trace` report give the reference's
      check quantities and levels, and its measured and predicted byte
      and op counts exactly
  (c) the tracer observes and never perturbs: a disabled tracer leaves
      losses, parameters and `StepMetrics` bit for bit as without it, and
      overlapped == serial stays bitwise with tracing on
"""

import dataclasses
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.edge_partition import partition_edges  # noqa: E402
from repro.core.graph import generate_graph as j_generate_graph  # noqa: E402
from repro.core.partition_book import build_vertex_book as j_vbook  # noqa: E402
from repro.core.vertex_partition import partition_vertices  # noqa: E402
from repro.fault import FaultPlan as JPlan  # noqa: E402
from repro.fault import recovery as j_rec  # noqa: E402
from repro.gnn import fullbatch as j_fb  # noqa: E402
from repro.gnn import inference as j_inf  # noqa: E402
from repro.gnn import minibatch as j_mb  # noqa: E402
from repro.gnn import models as jm  # noqa: E402
from repro.launch import gnn_trace as j_gnn_trace  # noqa: E402
from repro.obs import export as j_export  # noqa: E402
from repro.obs import reconcile as j_reconcile  # noqa: E402
from repro.obs import tracing as j_tracing  # noqa: E402
from repro.serve import build_serving as j_build_serving  # noqa: E402
from repro.serve import run_serving_sim as j_run_sim  # noqa: E402
from repro_torch.core.graph import generate_graph  # noqa: E402
from repro_torch.core.partition_book import build_vertex_book  # noqa: E402
from repro_torch.fault import FaultPlan  # noqa: E402
from repro_torch.fault import recovery  # noqa: E402
from repro_torch.gnn import fullbatch as t_fb  # noqa: E402
from repro_torch.gnn import inference as t_inf  # noqa: E402
from repro_torch.gnn import minibatch as t_mb  # noqa: E402
from repro_torch.gnn import models as tm  # noqa: E402
from repro_torch.launch import gnn_trace  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    TRACE_SCHEMA,
    Tracer,
    get_tracer,
    install,
    load_trace,
    phase_means,
    reconcile,
    to_chrome_trace,
    tracing,
    uninstall,
    validate_chrome_trace,
    write_trace,
)
from repro_torch.serve.engine import build_serving, run_serving_sim  # noqa: E402

CPU = torch.device("cpu")
DIMS = dict(feature_dim=12, hidden_dim=8, num_classes=5, num_layers=2)
# check units whose measured and predicted values are counts, not clocks
COUNTED = ("bytes", "ops")


@pytest.fixture(scope="module")
def node_setup():
    """tests/test_obs.py's graph and node data, in both packages."""
    jg = j_generate_graph("social", 150, 900, seed=3)
    tg = generate_graph("social", 150, 900, seed=3)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(jg.num_vertices, 12)).astype(np.float32)
    labels = rng.integers(0, 5, jg.num_vertices).astype(np.int32)
    train = rng.random(jg.num_vertices) < 0.4
    return jg, tg, feats, labels, train


def _minibatch(node_setup, *, codec=None, overlap=False, steps=3,
               ref=False):
    jg, tg, feats, labels, train = node_setup
    owner = partition_vertices(jg, 2, "metis", seed=0)
    if ref:
        spec = jm.GNNSpec(model="sage", **DIMS)
        tr = j_mb.MiniBatchTrainer.build(
            jg, owner, 2, spec, feats, labels, train, global_batch=32,
            seed=3, codec=codec, overlap=overlap)
    else:
        spec = tm.GNNSpec(model="sage", **DIMS)
        tr = t_mb.MiniBatchTrainer.build(
            tg, owner, 2, spec, feats, labels, train, device=CPU,
            global_batch=32, seed=3, codec=codec, overlap=overlap)
    ms = [tr.train_step() for _ in range(steps)]
    tr.close()
    return tr, ms


def _fullbatch(node_setup, *, model="sage", sync_mode="halo", codec=None,
               k=4, ref=False):
    jg, tg, feats, labels, train = node_setup
    a = partition_edges(jg, k, "blockrow" if sync_mode == "ring"
                        else "hep100", seed=0)
    if ref:
        return j_fb.FullBatchTrainer.build(
            jg, a, k, jm.GNNSpec(model=model, **DIMS), feats, labels, train,
            sync_mode=sync_mode, mode="sim", codec=codec)
    return t_fb.FullBatchTrainer.build(
        tg, a, k, tm.GNNSpec(model=model, **DIMS), feats, labels, train,
        sync_mode=sync_mode, codec=codec, device=CPU)


def _params(tr):
    return [t.clone() for lay in tr.params["layers"] for t in lay.values()]


def _same_checks(got, want):
    """Both packages' checks: one quantity list, one level each, and the
    counted quantities (bytes, ops) measured and predicted exactly."""
    assert [(c.quantity, c.program, c.unit) for c in got] == [
        (c.quantity, c.program, c.unit) for c in want]
    for a, b in zip(got, want):
        assert a.level == b.level, (a, b)
        assert a.tol_rel == b.tol_rel, (a, b)
        if a.unit in COUNTED:
            assert (a.measured, a.predicted) == (b.measured, b.predicted), (
                a, b)


# ---------------------------------------------------------------------------
# (a) tracer core
# ---------------------------------------------------------------------------


def test_disabled_tracer_records_nothing():
    """The module singleton starts disabled and stays empty no matter how
    much the instrumentation fires."""
    tr = get_tracer()
    assert not tr.enabled
    before = len(tr)
    with tr.span("x", cat="test"):
        pass
    tr.add("c", 123)
    tr.gauge("g", 1.0)
    tr.collective("all-reduce", 64)
    assert len(tr) == before == 0
    assert tr.total("c") is None


def test_tracing_no_behavior_change(node_setup):
    """Bitwise-identical loss trajectory with and without the tracer."""
    _, ms_off = _minibatch(node_setup)
    with tracing() as tr:
        _, ms_on = _minibatch(node_setup)
        assert len(tr) > 0
    assert [m.loss for m in ms_off] == [m.loss for m in ms_on]


def test_span_records_thread_and_duration():
    with tracing() as tr:
        def work():
            with tr.span("worker.op", cat="test", track="pool"):
                pass
        t = threading.Thread(target=work, name="pool-0")
        t.start()
        t.join()
        with tr.span("main.op", cat="test"):
            pass
    spans = tr.spans()
    assert {s.name for s in spans} == {"worker.op", "main.op"}
    by_name = {s.name: s for s in spans}
    assert by_name["worker.op"].thread == "pool-0"
    assert all(s.t1 >= s.t0 for s in spans)


def test_counter_totals_survive_ring_wrap():
    """`total()` is exact even after the event ring truncates."""
    with tracing(capacity=8) as tr:
        for _ in range(100):
            tr.add("bytes", 3)
    assert tr.total("bytes") == 300
    assert len(tr.counters("bytes")) == 8


def test_phase_clock_sums_to_wall():
    with tracing() as tr:
        clock = tr.phase_clock(cat="test")
        parts = [clock.split(f"p{i}") for i in range(4)]
    spans = tr.spans()
    assert len(spans) == 4
    for a, b in zip(spans, spans[1:]):
        assert a.t1 == b.t0
    assert sum(parts) == spans[-1].t1 - spans[0].t0


def test_step_metrics_phases_are_the_spans(node_setup):
    """The serial engine's StepMetrics phase times and the recorded spans
    are the same numbers, and the phases sum exactly to the step wall;
    the step spans are the StepMetrics' compute and wall."""
    with tracing() as tr:
        _, ms = _minibatch(node_setup, steps=2)
    by_name = {}
    for s in tr.spans():
        by_name.setdefault(s.name, []).append(s)
    for phase in ("sample", "fetch", "transfer"):
        spans = by_name[f"pipeline.{phase}"]
        assert len(spans) == len(ms)
        for s, m in zip(spans, ms):
            assert s.duration == getattr(m, f"{phase}_time_host")
    for s, m in zip(by_name["minibatch.step"], ms):
        assert s.duration == m.step_wall_host
    for m in ms:
        assert (m.sample_time_host + m.fetch_time_host
                + m.transfer_time_host + m.compute_time_host
                ) == pytest.approx(m.step_wall_host, abs=0, rel=0)
    pm = phase_means(ms)
    assert set(pm) == {"host_sample_time", "host_fetch_time",
                       "host_transfer_time", "host_compute_time",
                       "host_step_wall", "overlap_efficiency"}


# ---------------------------------------------------------------------------
# (a) export round-trip
# ---------------------------------------------------------------------------


def test_export_round_trip(tmp_path, node_setup):
    with tracing() as tr:
        _minibatch(node_setup, steps=2)
    path = tmp_path / "trace.json"
    payload = write_trace(str(path), tr)
    assert validate_chrome_trace(payload) == []
    loaded = load_trace(str(path))
    assert loaded["otherData"]["schema"] == TRACE_SCHEMA
    events = loaded["traceEvents"]
    open_stacks = {}
    for e in events:
        key = (e["pid"], e["tid"])
        if e["ph"] == "B":
            open_stacks.setdefault(key, []).append(e["name"])
        elif e["ph"] == "E":
            assert e["name"] in open_stacks.get(key, [])
            open_stacks[key].remove(e["name"])
    assert all(not v for v in open_stacks.values())
    last = {}
    for e in events:
        if e["ph"] == "M":
            continue
        key = (e["pid"], e["tid"])
        assert e["ts"] >= last.get(key, 0.0)
        last[key] = e["ts"]


def test_export_merges_tracers_and_clocks():
    t1 = Tracer()
    t1.record_span("a", 1.0, 2.0, cat="x")
    t2 = Tracer()
    t2.record_span("b", 5.0, 6.0, cat="x", clock="model", track="sim")
    t2.add("wire", 7, t=5.5, track="wire")
    payload = to_chrome_trace([t1, t2])
    assert validate_chrome_trace(payload) == []
    by_ph = {}
    for e in payload["traceEvents"]:
        by_ph.setdefault(e["ph"], []).append(e)
    assert len({e["pid"] for e in by_ph["B"]}) == 2
    assert by_ph["C"][0]["name"] == "wire"
    assert by_ph["C"][0]["args"] == {"value": 7.0}


def test_validator_flags_unpaired_and_nonmonotonic():
    bad = {"otherData": {"schema": TRACE_SCHEMA}, "traceEvents": [
        {"ph": "B", "name": "a", "pid": 1, "tid": 1, "ts": 2.0,
         "cat": "x", "args": {}},
        {"ph": "E", "name": "zzz", "pid": 1, "tid": 1, "ts": 1.0},
    ]}
    problems = validate_chrome_trace(bad)
    assert any("no open B" in p for p in problems)
    assert any("unclosed" in p for p in problems)
    assert any(" < " in p for p in problems)


# ---------------------------------------------------------------------------
# (a) reconciliation
# ---------------------------------------------------------------------------


def test_reconcile_minibatch_fp32_exact(node_setup):
    with tracing() as tr:
        trainer, ms = _minibatch(node_setup, steps=3)
        checks = reconcile.reconcile_minibatch(trainer, ms, tracer=tr)
    by_q = {c.quantity: c for c in checks}
    assert by_q["fetch.wire_bytes"].level == "ok"
    assert by_q["fetch.wire_bytes"].tol_rel == 0.0
    assert by_q["fetch.miss_bytes"].level == "ok"
    assert by_q["phase.closure"].level == "ok"
    assert all(c.level != "error" for c in checks)


def test_reconcile_minibatch_int8_ratio(node_setup):
    with tracing() as tr:
        trainer, ms = _minibatch(node_setup, codec="int8", steps=3)
        checks = reconcile.reconcile_minibatch(trainer, ms, tracer=tr)
    by_q = {c.quantity: c for c in checks}
    assert by_q["fetch.wire_bytes"].level == "ok"
    assert by_q["fetch.wire_ratio"].level == "ok"
    assert abs(by_q["fetch.wire_ratio"].measured - 0.25) < 0.05


def test_reconcile_minibatch_overlap_skips_fetch(node_setup):
    with tracing() as tr:
        trainer, ms = _minibatch(node_setup, overlap=True, steps=2)
        checks = reconcile.reconcile_minibatch(trainer, ms, tracer=tr)
    by_q = {c.quantity: c for c in checks}
    assert by_q["fetch.wire_bytes"].level == "warn"
    assert by_q["phase.closure"].level == "warn"
    assert reconcile.build_report(checks).exit_code == 0


def test_reconcile_injected_byte_is_an_error(node_setup):
    with tracing() as tr:
        trainer, ms = _minibatch(node_setup, steps=2)
        tr.add("fetch.wire_bytes", 1)
        checks = reconcile.reconcile_minibatch(trainer, ms, tracer=tr)
    by_q = {c.quantity: c for c in checks}
    assert by_q["fetch.wire_bytes"].level == "error"
    report = reconcile.build_report(checks)
    assert report.exit_code == 1
    assert report.counts["error"] == 1


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_reconcile_fullbatch_halo_exact(node_setup, model):
    with tracing() as tr:
        trainer = _fullbatch(node_setup, model=model)
        trainer.train_step()
        checks = reconcile.reconcile_fullbatch(trainer, tracer=tr)
    by_q = {c.quantity: c for c in checks}
    assert by_q["sync.count.all-to-all"].level == "ok"
    assert by_q["sync.cluster_bytes.all-to-all"].level == "ok"
    assert by_q["sync.wire_bytes.forward"].level == "ok"
    assert by_q["epoch.wire_bytes"].level == "ok"
    assert all(c.tol_rel == 0.0 for c in checks)


def test_reconcile_fullbatch_tracer_installed_after_step_one(node_setup):
    """Nothing is compiled once and cached: a tracer installed after step
    1 records step 2's forward in full, and every pass it recorded (step
    2's, then `forward_logits_global`'s) reconciles; passes that disagree
    are an error."""
    trainer = _fullbatch(node_setup, k=2)
    trainer.train_step()
    with tracing() as tr:
        trainer.train_step()
        trainer.forward_logits_global()
        checks = reconcile.reconcile_fullbatch(trainer, tracer=tr)
    assert {e.forward for e in tr.collectives()}.__len__() == 2
    assert checks and all(c.level == "ok" for c in checks)
    assert len(tr.spans("fullbatch.step")) == 1
    tr.collective("all-to-all", 8, wire_bytes=8, forward=-1)
    bad = reconcile.reconcile_fullbatch(trainer, tracer=tr)
    assert [c.quantity for c in bad if c.level == "error"] == [
        "sync.forward_passes"]


def _serving_run(node_setup, requests=80, ref=False):
    jg, tg, feats, _, _ = node_setup
    jspec = jm.GNNSpec(model="sage", **DIMS)
    jparams = jm.init_params(jspec, seed=0)
    a = partition_edges(jg, 2, "hep100", seed=0)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jg.num_vertices, requests)
    arrivals = np.sort(rng.uniform(0.0, requests / 300.0, requests))
    kw = dict(hops=1, fanout=6, max_batch=8, max_wait=5e-4, seed=0)
    if ref:
        eng = j_inf.LayerwiseInference.build(jg, a, 2, jspec, jparams, feats)
        owner = eng.book.master_assignment()
        engines, batchers, store = j_build_serving(
            jg, j_vbook(jg, owner, 2), jspec, jparams, eng.run(), **kw)
        report = j_run_sim(engines, batchers, owner, ids, arrivals)
        return report, store
    spec = tm.GNNSpec(model="sage", **DIMS)
    params = tm.params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    eng = t_inf.LayerwiseInference.build(tg, a, 2, spec, params, feats,
                                         device=CPU)
    owner = eng.book.master_assignment()
    engines, batchers, store = build_serving(
        tg, build_vertex_book(tg, owner, 2), spec, params, eng.run(),
        device=CPU, **kw)
    report = run_serving_sim(engines, batchers, owner, ids, arrivals)
    return report, store


def test_reconcile_serving_exact(node_setup):
    with tracing() as tr:
        report, store = _serving_run(node_setup)
        checks = reconcile.reconcile_serving(report, store, tracer=tr)
    by_q = {c.quantity: c for c in checks}
    assert by_q["serve.fetch.wire_bytes"].level == "ok"
    assert by_q["serve.fetch.stats_wire_bytes"].level == "ok"
    assert by_q["serve.latency.closure"].level == "ok"
    tracks = {s.track for s in tr.spans() if s.clock == "model"}
    assert any(t and t.endswith(".queue") for t in tracks)
    # the host spans: one gather and one compute a micro-batch, the
    # compute span's duration the report's host time
    compute = tr.spans("serve.compute")
    assert len(compute) == len(tr.spans("serve.gather")) == len(
        report.host_time)
    np.testing.assert_array_equal([s.duration for s in compute],
                                  report.host_time)
    assert len(tr.spans("inference.layer")) == DIMS["num_layers"]


GNN_TRACE_ARGS = ["--scale", "0.01", "--k", "2", "--steps", "1",
                  "--requests", "30"]


def test_gnn_trace_cli_green_and_red(tmp_path):
    out_trace = tmp_path / "t.json"
    out_json = tmp_path / "r.json"
    argv = GNN_TRACE_ARGS + ["--device", "cpu", "--out-trace",
                             str(out_trace), "--out-json", str(out_json)]
    assert gnn_trace.main(argv) == 0
    report = json.loads(out_json.read_text())
    assert report["schema"] == "gnn-trace-report/v2"
    assert report["counts"]["error"] == 0
    assert set(report["programs"]) == {"fullbatch-halo", "fullbatch-ring",
                                       "minibatch", "serve"}
    assert load_trace(str(out_trace))["otherData"]["schema"] == TRACE_SCHEMA

    assert gnn_trace.main(argv + ["--inject-violation"]) == 1
    report = json.loads(out_json.read_text())
    assert report["exit_code"] == 1
    bad = [c for c in report["checks"] if c["level"] == "error"]
    assert len(bad) == 1
    assert bad[0]["quantity"] == "fetch.wire_bytes"


def test_install_uninstall_restores_null():
    prev = get_tracer()
    t = install(Tracer())
    assert get_tracer() is t
    uninstall()
    assert get_tracer() is prev
    assert not get_tracer().enabled


# ---------------------------------------------------------------------------
# (b) across the packages
# ---------------------------------------------------------------------------


def test_timelines_cross_between_the_packages(tmp_path, node_setup):
    """A timeline the port writes passes the reference's validator with no
    problem; the reference's loads through the port's `load_trace`."""
    with tracing() as tr:
        _minibatch(node_setup, steps=2)
        _serving_run(node_setup, requests=20)
    port = write_trace(str(tmp_path / "port.json"), tr)
    assert j_export.validate_chrome_trace(port) == []
    with j_tracing() as jtr:
        _minibatch(node_setup, steps=2, ref=True)
    path = str(tmp_path / "ref.json")
    j_export.write_trace(path, jtr)
    assert load_trace(path)["otherData"]["schema"] == TRACE_SCHEMA
    # one schema, one event vocabulary: the same span names on both sides
    names = {e["name"] for e in port["traceEvents"] if e["ph"] == "B"}
    ref = {e["name"] for e in load_trace(path)["traceEvents"]
           if e["ph"] == "B"}
    assert ref <= names


@pytest.mark.parametrize("codec", ["fp32", "int8"])
@pytest.mark.parametrize("sync_mode", ["halo", "ring"])
def test_reconcile_fullbatch_matches_reference(node_setup, sync_mode, codec):
    """Two steps a package: the port records two forward passes, the
    reference one trace; the checks agree quantity for quantity, the
    counts and bytes exactly (the stacked [k, ...] sizes are the
    reference's per-device sizes times k, never k times again)."""
    with tracing() as tr:
        trainer = _fullbatch(node_setup, model="gat", sync_mode=sync_mode,
                             codec=codec)
        for _ in range(2):
            trainer.train_step()
        got = reconcile.reconcile_fullbatch(trainer, tracer=tr)
    with j_tracing() as jtr:
        jtrainer = _fullbatch(node_setup, model="gat", sync_mode=sync_mode,
                              codec=codec, ref=True)
        for _ in range(2):
            jtrainer.train_step()
        want = j_reconcile.reconcile_fullbatch(jtrainer, tracer=jtr)
    _same_checks(got, want)
    assert all(c.level == "ok" for c in got)
    # event by event: kind, layer and bytes, in recording order
    passes = {}
    for e in tr.collectives():
        passes.setdefault(e.forward, []).append(
            (e.kind, e.layer, e.cluster_bytes, e.wire_bytes))
    assert len(passes) == 2
    for events in passes.values():
        assert events == [(e.kind, e.layer, e.cluster_bytes, e.wire_bytes)
                          for e in jtr.collectives()]


@pytest.mark.parametrize("codec", [None, "int8"])
def test_reconcile_minibatch_matches_reference(node_setup, codec):
    with tracing() as tr:
        trainer, ms = _minibatch(node_setup, codec=codec, steps=3)
        got = reconcile.reconcile_minibatch(trainer, ms, tracer=tr)
    with j_tracing() as jtr:
        jtrainer, jms = _minibatch(node_setup, codec=codec, steps=3,
                                   ref=True)
        want = j_reconcile.reconcile_minibatch(jtrainer, jms, tracer=jtr)
    _same_checks(got, want)
    for name in ("fetch.wire_bytes", "fetch.miss_bytes"):
        assert tr.total(name) == jtr.total(name)


def test_reconcile_serving_matches_reference(node_setup):
    with tracing() as tr:
        report, store = _serving_run(node_setup)
        got = reconcile.reconcile_serving(report, store, tracer=tr)
    with j_tracing() as jtr:
        jreport, jstore = _serving_run(node_setup, ref=True)
        want = j_reconcile.reconcile_serving(jreport, jstore, tracer=jtr)
    _same_checks(got, want)
    closure = [(c.measured, c.predicted) for c in got + want
               if c.quantity == "serve.latency.closure"]
    assert closure[0] == closure[1]


ELASTIC = ["worker-loss@epoch:1,worker:2", "worker-join@epoch:3"]


def test_reconcile_recovery_matches_reference(node_setup):
    """An elastic run shrinking and growing back: the fault counters agree
    with each package's plan, one recovery span a rescale, the traced
    modeled recovery time with its estimates, as in the reference."""
    jg, tg, feats, labels, train = node_setup
    plan = FaultPlan.parse(ELASTIC, seed=0)
    with tracing() as tr:
        res = recovery.run_elastic_fullbatch(
            tg, feats, labels, train, tm.GNNSpec(model="sage", **DIMS), k=4,
            epochs=5, plan=plan, partitioner="hep100", seed=0, device=CPU)
        got = reconcile.reconcile_recovery(
            plan, tracer=tr, estimates=res.recovery_estimates)
    j_plan = JPlan.parse(ELASTIC, seed=0)
    with j_tracing() as jtr:
        jres = j_rec.run_elastic_fullbatch(
            jg, feats, labels, train, jm.GNNSpec(model="sage", **DIMS), k=4,
            epochs=5, plan=j_plan, partitioner="hep100", seed=0)
        want = j_reconcile.reconcile_recovery(
            j_plan, tracer=jtr, estimates=jres.recovery_estimates)
    _same_checks(got, want)
    assert all(c.level == "ok" for c in got)
    for name in ("fault.restore", "fault.repartition", "fault.recovery",
                 "fault.recompile", "fault.inject"):
        assert len(tr.spans(name)) == len(jtr.spans(name)) > 0, name


def test_gnn_trace_report_matches_reference(tmp_path):
    """The port's gnn_trace and the reference's on the same arguments: the
    same programs and checks, levels, and counted quantities."""
    out = {}
    for name, main, extra in (("port", gnn_trace.main, ["--device", "cpu"]),
                              ("ref", j_gnn_trace.main, [])):
        path = tmp_path / f"{name}.json"
        assert main(GNN_TRACE_ARGS + extra + [
            "--out-trace", str(tmp_path / f"{name}_t.json"),
            "--out-json", str(path)]) == 0
        out[name] = json.loads(path.read_text())
    port, ref = out["port"], out["ref"]
    assert port["counts"] == ref["counts"]
    assert port["programs"] == ref["programs"]
    for a, b in zip(port["checks"], ref["checks"], strict=True):
        assert (a["quantity"], a["program"], a["level"], a["unit"]) == (
            b["quantity"], b["program"], b["level"], b["unit"])
        if a["unit"] in COUNTED:
            assert (a["measured"], a["predicted"]) == (b["measured"],
                                                       b["predicted"])


# ---------------------------------------------------------------------------
# (c) observe, never perturb
# ---------------------------------------------------------------------------


def _metrics_tuple(m):
    return tuple(
        v.tolist() if isinstance(v, np.ndarray) else v
        for k, v in dataclasses.asdict(m).items() if not k.endswith("_host"))


def test_disabled_tracer_is_a_bitwise_no_op(node_setup):
    """The disabled singleton, explicitly installed, against an enabled
    tracer and against none: the same losses, final parameters and
    `StepMetrics` (every field but the host clocks) bit for bit, full
    batch and mini batch; the disabled tracer records nothing."""
    install(Tracer(enabled=False))
    try:
        off, ms_off = _minibatch(node_setup)
        fb_off = _fullbatch(node_setup, model="gat")
        fb_off_losses = [fb_off.train_step() for _ in range(3)]
        assert len(get_tracer()) == 0
    finally:
        uninstall()
    plain, ms_plain = _minibatch(node_setup)
    with tracing():
        on, ms_on = _minibatch(node_setup)
        fb_on = _fullbatch(node_setup, model="gat")
        fb_on_losses = [fb_on.train_step() for _ in range(3)]
    fb_plain = _fullbatch(node_setup, model="gat")
    assert fb_off_losses == fb_on_losses == [fb_plain.train_step()
                                             for _ in range(3)]
    for a, b in ((off, plain), (on, plain), (fb_off, fb_plain),
                 (fb_on, fb_plain)):
        assert all(torch.equal(x, y) for x, y in zip(_params(a),
                                                     _params(b)))
    assert ([_metrics_tuple(m) for m in ms_off]
            == [_metrics_tuple(m) for m in ms_plain]
            == [_metrics_tuple(m) for m in ms_on])


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_overlapped_equals_serial_with_tracing_on(node_setup, model):
    jg, tg, feats, labels, train = node_setup
    owner = partition_vertices(jg, 2, "metis", seed=0)
    spec = tm.GNNSpec(model=model, agg_backend="tiled", **DIMS)
    out = {}
    for overlap in (False, True):
        with tracing() as tr:
            trainer = t_mb.MiniBatchTrainer.build(
                tg, owner, 2, spec, feats, labels, train, device=CPU,
                global_batch=32, seed=3, overlap=overlap)
            ms = [trainer.train_step() for _ in range(3)]
            trainer.close()
        out[overlap] = ([m.loss for m in ms], _params(trainer))
        assert len(tr.spans("minibatch.step")) == 3
        if overlap:
            assert tr.spans("pipeline.queue_wait")
    assert out[True][0] == out[False][0]
    assert all(torch.equal(x, y) for x, y in zip(out[True][1],
                                                 out[False][1]))

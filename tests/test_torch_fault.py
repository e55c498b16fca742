"""The port's fault layer against the JAX package's, on the CPU (the
reference's sizes of tests/test_fault.py: OR 0.02, k=4, widths 16 / 8).

  (a) the spec grammar: every spec of tests/test_fault.py (and the other
      kinds) parses to the reference's `FaultEvent`, or fails with its
      message; the plan's fire-once books and seeded worker choice
  (b) `retry_call` bookkeeping and escalation
  (c) the pipeline seams: retried / absorbed faults leave every batch bit
      for bit the unfaulted one (and the reference's faulted one), serial
      and overlapped; an injected crash reaches the consumer as
      `WorkerCrash`; the module-level gather hook
  (d) crash and resume bit for bit within the port: mini batch (sage, gat
      x serial, overlapped), full batch under fp32 and under int8 with its
      EF carry; no test sets PyTorch's deterministic mode (both trainers'
      steps run under `minibatch.repeatable_step`)
  (e) elastic rescale carries lr, the codec (and its tier) and the EF
      carry, and keeps distributed == single; `run_elastic_fullbatch`
      shrinks and grows like the reference's, losses within 1e-4
      (tests/test_gnn_distributed.py:53), the same `_state_bytes`
  (f) `failover_assignment` bit for bit the reference's; serving under a
      worker death gives the reference's report
  (g) the CLIs: an unknown spec exits 1 naming the valid kinds, `main`
      exits 3 on an injected crash, `--resume` ends on the uninterrupted
      run's final loss exactly (full batch at the CLI's defaults too),
      `gnn_serve` answers every request past a worker death
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import cost_model as j_cost  # noqa: E402
from repro.core.edge_partition import partition_edges  # noqa: E402
from repro.core.graph import paper_graph as j_paper_graph  # noqa: E402
from repro.core.partition_book import build_edge_book as j_edge_book  # noqa: E402
from repro.core.partition_book import build_vertex_book as j_vbook  # noqa: E402
from repro.core.vertex_partition import partition_vertices  # noqa: E402
from repro.fault import FaultInjector as JInjector  # noqa: E402
from repro.fault import FaultPlan as JPlan  # noqa: E402
from repro.fault import FaultSpecError as JSpecError  # noqa: E402
from repro.fault import parse_fault_spec as j_parse  # noqa: E402
from repro.fault import recovery as j_rec  # noqa: E402
from repro.gnn import fullbatch as j_fb  # noqa: E402
from repro.gnn import inference as j_inf  # noqa: E402
from repro.gnn import minibatch as j_mb  # noqa: E402
from repro.gnn import models as jm  # noqa: E402
from repro.serve import build_serving as j_build_serving  # noqa: E402
from repro.serve import run_serving_sim as j_run_sim  # noqa: E402
from repro_torch.ckpt import CheckpointManager, checkpoint_extra  # noqa: E402
from repro_torch.ckpt.elastic import rescale_fullbatch  # noqa: E402
from repro_torch.core import cost_model  # noqa: E402
from repro_torch.core.graph import paper_graph  # noqa: E402
from repro_torch.core.partition_book import build_edge_book  # noqa: E402
from repro_torch.core.partition_book import build_vertex_book  # noqa: E402
from repro_torch.core.wire import as_codec  # noqa: E402
from repro_torch.fault import (  # noqa: E402
    FaultEscalation,
    FaultInjector,
    FaultPlan,
    FaultSpecError,
    TransientFetchFault,
    WorkerCrash,
    clear_fetch_hook,
    install_fetch_hook,
    parse_fault_spec,
    retry_call,
)
from repro_torch.fault import recovery  # noqa: E402
from repro_torch.gnn import fullbatch as t_fb  # noqa: E402
from repro_torch.gnn import inference as t_inf  # noqa: E402
from repro_torch.gnn import minibatch as t_mb  # noqa: E402
from repro_torch.gnn import models as tm  # noqa: E402
from repro_torch.launch import gnn_serve, gnn_train  # noqa: E402
from repro_torch.serve.engine import build_serving, run_serving_sim  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_gnn_distributed.py:38
LOSS_TOL = 1e-4                   # tests/test_gnn_distributed.py:53
DIMS = dict(feature_dim=16, hidden_dim=8, num_classes=5, num_layers=2)


@pytest.fixture(scope="module")
def data():
    """Both packages' OR 0.02 graphs, tests/conftest.py's node data and the
    metis vertex partition tests/test_fault.py trains on."""
    jg = j_paper_graph("OR", scale=0.02, seed=0)
    tg = paper_graph("OR", scale=0.02, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(jg.num_vertices, 16)).astype(np.float32)
    labels = rng.integers(0, 5, jg.num_vertices).astype(np.int32)
    train = rng.random(jg.num_vertices) < 0.3
    assignment = partition_vertices(jg, 4, "metis", seed=0)
    return jg, tg, feats, labels, train, assignment


def _port_mb(data, *, overlap, model="sage", seed=3, **kw):
    _, tg, feats, labels, train, a = data
    spec = tm.GNNSpec(model=model, **DIMS)
    return t_mb.MiniBatchTrainer.build(
        tg, a, 4, spec, feats, labels, train, device=CPU, global_batch=32,
        seed=seed, overlap=overlap, **kw)


def _ref_mb(data, *, overlap, model="sage", seed=3, **kw):
    jg, _, feats, labels, train, a = data
    spec = jm.GNNSpec(model=model, **DIMS)
    return j_mb.MiniBatchTrainer.build(
        jg, a, 4, spec, feats, labels, train, global_batch=32, seed=seed,
        overlap=overlap, **kw)


def _flat(stacked) -> dict:
    out = {k: v for k, v in stacked.items() if k != "layers"}
    for li, lay in enumerate(stacked["layers"]):
        out.update({f"layers[{li}].{k}": v for k, v in lay.items()})
    return out


def _assert_batches_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for name in fa:
        x, y = fa[name], fb[name]
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


def _params(tr, tree="params"):
    tree = getattr(tr, tree)
    return [t.clone() for layer in tree["layers"] for t in layer.values()]


def _bitwise(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ----------------------------------------------------------- (a) the grammar
SPECS = ["crash@step:3", "straggler@step:1,worker:2,delay:0.05",
         "worker-death@t:0.5,worker:1", "corrupt-ckpt",
         "sample-error@step:2,worker:1", "fetch-error@step:4,worker:0",
         "fetch-error@worker:1", "worker-loss@epoch:2,worker:1",
         "worker-join@epoch:4", "worker-death@at:0.25",
         "explode@step:1", "crash@step", "crash@step:x", "crash@fuse:1",
         "crash@step:1,"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_fault_spec_matches_reference(spec):
    try:
        expect = j_parse(spec)
    except JSpecError as e:
        with pytest.raises(FaultSpecError) as ei:
            parse_fault_spec(spec)
        assert str(ei.value) == str(e)
        if spec.startswith("explode"):
            assert "valid kinds" in str(e) and "crash" in str(e)
        return
    got = parse_fault_spec(spec)
    assert dataclasses.asdict(got) == dataclasses.asdict(expect)
    assert got.describe() == expect.describe()


def test_plan_fire_once_and_seeded_worker():
    plan = FaultPlan.parse(["crash@step:3", "worker-death@t:0.5"], seed=7)
    ev = plan.events[0]
    assert plan.fire(ev) and not plan.fire(ev)
    assert plan.injected_count == 1 and plan.handled_count == 0
    assert plan.mark_handled(ev) and not plan.mark_handled(ev)
    assert not plan.mark_handled(plan.events[1])  # never fired
    assert plan.fired_events() == [ev] and len(plan) == 2
    # the seeded choice of an open worker is the reference's: stable across
    # calls and equal plans, (seed, event index) -> the same worker
    for seed in range(6):
        specs = ["sample-error@step:1", "worker-death@t:0.5",
                 "worker-loss@epoch:2"]
        port, ref = FaultPlan.parse(specs, seed=seed), JPlan.parse(specs,
                                                                   seed=seed)
        for k in (2, 3, 4, 7):
            for pe, re_ in zip(port.events, ref.events):
                w = port.resolve_worker(pe, k)
                assert w == ref.resolve_worker(re_, k)
                assert w == port.resolve_worker(pe, k + 1)  # memoised


# ----------------------------------------------------------- (b) retry_call
def test_retry_call_books_and_escalates():
    plan = FaultPlan.parse(["fetch-error@step:0,worker:0"], seed=0)
    ev = plan.events[0]
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] == 1 and plan.fire(ev):
            raise TransientFetchFault("injected", event=ev, plan=plan)
        return calls["n"]

    assert retry_call(flaky, phase="fetch", backoff=1e-4) == 2
    assert plan.injected_count == plan.handled_count == 1

    def always():
        raise TransientFetchFault("down")

    with pytest.raises(FaultEscalation, match="after 2 attempt"):
        retry_call(always, phase="fetch", attempts=2, backoff=1e-4)
    # the deadline escalates before the attempts run out
    with pytest.raises(FaultEscalation, match="timeout=0.001s"):
        retry_call(always, phase="sample", attempts=50, backoff=1e-3,
                   timeout=1e-3)


# ------------------------------------------------------- (c) pipeline seams
RETRIED = ["straggler@step:0,worker:1,delay:0.01",
           "sample-error@step:1,worker:2", "fetch-error@step:2,worker:0"]


@pytest.mark.parametrize("overlap", [False, True])
def test_retried_batches_bitwise_identical(data, overlap):
    """A straggler, a sampler fault and a fetch fault, absorbed or retried:
    every batch is bit for bit the unfaulted run's, and (serial) the
    reference's faulted run's."""
    plan = FaultPlan.parse(RETRIED, seed=0)
    clean = _port_mb(data, overlap=overlap)
    faulted = _port_mb(data, overlap=overlap, injector=FaultInjector(plan))
    ref = None
    if not overlap:
        j_plan = JPlan.parse(RETRIED, seed=0)
        ref = _ref_mb(data, overlap=False, injector=JInjector(j_plan))
    try:
        for step in range(4):
            pb_c, _ = clean.engine.next_batch()
            pb_f, _ = faulted.engine.next_batch()
            assert pb_c.index == pb_f.index == step
            _assert_batches_equal(pb_c.host, pb_f.host)
            _assert_batches_equal(pb_c.stacked, pb_f.stacked)
            np.testing.assert_array_equal(pb_c.input_vertices,
                                          pb_f.input_vertices)
            if ref is not None:
                pb_r, _ = ref.engine.next_batch()
                _assert_batches_equal(pb_f.host, pb_r.stacked)
                assert pb_f.fetch_stats == pb_r.fetch_stats
    finally:
        clean.close()
        faulted.close()
        if ref is not None:
            ref.close()
    assert plan.injected_count == plan.handled_count == 3
    if ref is not None:
        assert j_plan.injected_count == j_plan.handled_count == 3


@pytest.mark.parametrize("overlap", [False, True])
def test_crash_surfaces_as_worker_crash(data, overlap):
    """An injected crash crosses the producer boundary as itself, not as
    a wrapped RuntimeError, after the batches before it."""
    plan = FaultPlan.parse(["crash@step:2"], seed=0)
    tr = _port_mb(data, overlap=overlap, injector=FaultInjector(plan))
    seen = []
    try:
        with pytest.raises(WorkerCrash, match="step 2"):
            for _ in range(4):
                seen.append(tr.engine.next_batch()[0].index)
    finally:
        tr.close()
    assert seen == [0, 1]
    assert plan.injected_count == 1 and plan.handled_count == 0


def test_gather_seam_global_hook(data):
    """The module-level `RowStore.gather` hook: a step-agnostic fetch-error
    raised at the store is retried by the pipeline, bit for bit."""
    plan = FaultPlan.parse(["fetch-error@worker:1"], seed=0)
    clean = _port_mb(data, overlap=False)
    faulted = _port_mb(data, overlap=False)
    install_fetch_hook(FaultInjector(plan, k=4).gather_hook())
    try:
        for _ in range(2):
            pb_c, _ = clean.engine.next_batch()
            pb_f, _ = faulted.engine.next_batch()
            _assert_batches_equal(pb_c.host, pb_f.host)
    finally:
        clear_fetch_hook()
        clean.close()
        faulted.close()
    assert plan.injected_count == plan.handled_count == 1


# ------------------------------------------------- (d) crash and resume
def _run_minibatch(data, *, overlap, model, steps, ckpt_dir=None, plan=None,
                   start_step=0):
    """The gnn_train mini-batch loop in miniature: per-step checkpoints,
    crash capture, resume via start_step + restore."""
    mgr = CheckpointManager(ckpt_dir, keep=3, every=1) if ckpt_dir else None
    tr = _port_mb(data, overlap=overlap, model=model,
                  injector=FaultInjector(plan) if plan else None,
                  start_step=start_step)
    losses, crashed = [], False
    try:
        if mgr is not None and start_step > 0:
            _, restored = mgr.restore(
                {"params": tr.params, "opt_state": tr.opt_state})
            tr.params = restored["params"]
            tr.opt_state = restored["opt_state"]
        for step in range(start_step, steps):
            losses.append(tr.train_step().loss)
            if mgr is not None:
                mgr.maybe_save(step, {"params": tr.params,
                                      "opt_state": tr.opt_state})
    except WorkerCrash:
        crashed = True
    finally:
        tr.close()
    return losses, crashed, tr


@pytest.mark.parametrize("model", ["sage", "gat"])
@pytest.mark.parametrize("overlap", [False, True])
def test_minibatch_crash_resume_bitwise(data, tmp_path, model, overlap):
    """Kill at step 3 of 6, resume from the checkpoint: steps 3-5 and the
    final parameters are the uninterrupted run's, bit for bit."""
    oracle, crashed, full = _run_minibatch(data, overlap=overlap,
                                           model=model, steps=6)
    assert not crashed and len(oracle) == 6
    d = str(tmp_path / "ck")
    plan = FaultPlan.parse(["crash@step:3"], seed=0)
    pre, crashed, _ = _run_minibatch(data, overlap=overlap, model=model,
                                     steps=6, ckpt_dir=d, plan=plan)
    assert crashed and pre == oracle[:3]
    step_r, _ = checkpoint_extra(d)
    assert step_r == 2
    post, crashed, resumed = _run_minibatch(
        data, overlap=overlap, model=model, steps=6, ckpt_dir=d,
        start_step=step_r + 1)
    assert not crashed
    assert post == oracle[3:]
    assert _bitwise(_params(resumed), _params(full))


@pytest.mark.parametrize("codec", [None, "int8"])
def test_fullbatch_crash_resume_bitwise(data, tmp_path, codec):
    """Full batch crashed at epoch 2 and resumed from the epoch-1
    checkpoint (params, Adam state and, under int8, the EF carry): epochs
    2-4, the final parameters and the final EF carry are the uninterrupted
    run's, bit for bit."""
    jg, tg, feats, labels, train, _ = data
    spec = tm.GNNSpec(model="sage", **DIMS)
    a = partition_edges(jg, 4, "hep100", seed=1)

    def build():
        return t_fb.FullBatchTrainer.build(
            tg, a, 4, spec, feats, labels, train, seed=7, codec=codec,
            device=CPU)

    full = build()
    oracle = [full.train_step() for _ in range(5)]

    def state(tr):
        tree = {"params": tr.params, "opt_state": tr.opt_state}
        if tr.ef_state is not None:
            tree["ef"] = tr.ef_state
        return tree

    d = str(tmp_path / "fb")
    mgr = CheckpointManager(d, keep=3, every=1)
    injector = FaultInjector(FaultPlan.parse(["crash@step:2"], seed=0), k=4)
    tr = build()
    pre = []
    with pytest.raises(WorkerCrash):
        for epoch in range(5):
            injector.at_epoch(epoch)
            pre.append(tr.train_step())
            mgr.maybe_save(epoch, state(tr), extra={
                "epoch": epoch, "has_ef": tr.ef_state is not None})
    assert pre == oracle[:2]

    step_r, extra = checkpoint_extra(d)
    assert (step_r, extra["epoch"], extra["has_ef"]) == (1, 1,
                                                         codec is not None)
    tr = build()
    if extra["has_ef"]:
        tr.ef_state = tr._init_ef()
    _, restored = mgr.restore(state(tr))
    tr.params, tr.opt_state = restored["params"], restored["opt_state"]
    tr.ef_state = restored.get("ef")
    post = [tr.train_step() for _ in range(extra["epoch"] + 1, 5)]
    assert post == oracle[2:]
    assert _bitwise(_params(tr), _params(full))
    if codec is not None:
        assert _bitwise(_params(tr, "ef_state"), _params(full, "ef_state"))


# ------------------------------------------------------------- (e) elastic
def test_rescale_carries_runtime_state(data):
    from repro_torch.core.wire import make_codec

    jg, tg, feats, labels, train, _ = data
    spec = tm.GNNSpec(model="sage", **DIMS)
    a = partition_edges(jg, 4, "hdrf", seed=1)
    tr = t_fb.FullBatchTrainer.build(tg, a, 4, spec, feats, labels, train,
                                     seed=7, lr=5e-2, codec="int8",
                                     device=CPU)
    tr.train_step()
    assert tr.ef_state is not None
    tr2 = rescale_fullbatch(tr, tg, 3, feats, labels, train, seed=2)
    assert tr2.lr == tr.lr == 5e-2 and tr2.book.k == 3
    assert tr2.sync_mode == tr.sync_mode
    assert as_codec(tr2.codec).name == "int8"
    for old, new in zip(_params(tr, "ef_state"), _params(tr2, "ef_state")):
        assert old.shape[0] == 4 and new.shape[0] == 3
        for j in range(3):
            assert torch.equal(new[j], old.mean(dim=0))
    assert tr2.train_step() > 0
    # an advanced variable codec keeps its tier; k=1 unstacks the EF carry
    tr = t_fb.FullBatchTrainer.build(tg, a, 4, spec, feats, labels, train,
                                     seed=7, codec=make_codec("variable"),
                                     device=CPU)
    tr.set_epoch(3)
    tr.train_step()
    tr1 = rescale_fullbatch(tr, tg, 1, feats, labels, train, seed=2)
    assert tr1.codec is tr.codec and tr1.codec.epoch == 3
    if tr.ef_state is not None:
        assert all(n.shape == p.shape for n, p in
                   zip(_params(tr1, "ef_state"), _params(tr1)))
    # fp32 shrink 4 -> 3: distributed == single survives the rescale
    tr = t_fb.FullBatchTrainer.build(tg, a, 4, spec, feats, labels, train,
                                     seed=7, lr=5e-2, device=CPU)
    tr.train_step()
    tr2 = rescale_fullbatch(tr, tg, 3, feats, labels, train, seed=2)
    assert tr2.lr == 5e-2
    ref = t_fb.FullBatchTrainer.build(
        tg, np.zeros(tg.num_edges, np.int32), 1, spec, feats, labels, train,
        seed=7, device=CPU)
    ref.params = tr.params
    np.testing.assert_allclose(tr2.forward_logits_global(),
                               ref.forward_logits_global(), **TOL)


ELASTIC = ["worker-loss@epoch:1,worker:2", "worker-join@epoch:3"]


def test_elastic_driver_matches_reference(data):
    """The supervised driver shrinks at epoch 1 and grows back at epoch 3
    as the reference's does: the same k history and actions, losses within
    LOSS_TOL a step, the same checkpointable bytes, priced recoveries."""
    jg, tg, feats, labels, train, _ = data
    plan = FaultPlan.parse(ELASTIC, seed=0)
    res = recovery.run_elastic_fullbatch(
        tg, feats, labels, train, tm.GNNSpec(model="sage", **DIMS), k=4,
        epochs=5, plan=plan, partitioner="hep100", seed=0, device=CPU)
    j_plan = JPlan.parse(ELASTIC, seed=0)
    jres = j_rec.run_elastic_fullbatch(
        jg, feats, labels, train, jm.GNNSpec(model="sage", **DIMS), k=4,
        epochs=5, plan=j_plan, partitioner="hep100", seed=0)
    assert res.k_history == jres.k_history == [4, 3, 3, 4, 4]
    assert [(e.epoch, e.action, e.old_k, e.new_k) for e in res.events] == [
        (e.epoch, e.action, e.old_k, e.new_k) for e in jres.events]
    for step, (a, b) in enumerate(zip(res.losses, jres.losses)):
        assert abs(a - b) < LOSS_TOL, (step, a, b)
    assert plan.injected_count == plan.handled_count == 2
    assert all(e.estimate.recovery_time > 0 and e.compile_s > 0
               for e in res.events)
    assert res.recovery_time_total == pytest.approx(
        sum(e.estimate.recovery_time for e in res.events))
    assert recovery._state_bytes(res.trainer) == j_rec._state_bytes(
        jres.trainer)


def test_state_bytes_and_recovery_time_match_reference(data):
    """`_state_bytes` counts the reference's bytes with an EF carry too, and
    `recovery_time` prices a recovery as the reference does."""
    jg, tg, feats, labels, train, _ = data
    a = partition_edges(jg, 4, "hep100", seed=1)
    jtr = j_fb.FullBatchTrainer.build(jg, a, 4, jm.GNNSpec(model="gat",
                                                           **DIMS),
                                      feats, labels, train, codec="int8")
    ttr = t_fb.FullBatchTrainer.build(tg, a, 4, tm.GNNSpec(model="gat",
                                                           **DIMS),
                                      feats, labels, train, codec="int8",
                                      device=CPU)
    jtr.train_step()
    ttr.train_step()
    assert recovery._state_bytes(ttr) == j_rec._state_bytes(jtr) > 0
    for nbytes, t in [(0, 0.0), (12345, 0.25), (3.5e9, 17.0)]:
        for kw in ({}, {"compile_time": 2.0}):
            got = cost_model.recovery_time(nbytes, t, **kw)
            expect = j_cost.recovery_time(nbytes, t, **kw)
            assert dataclasses.astuple(got) == dataclasses.astuple(expect)
            assert got.recovery_time == expect.recovery_time


# ------------------------------------------------------------ (f) failover
class _Book:  # minimal replica map: vglobal[p][vmask[p]] = copies on p
    vglobal = [np.array([0, 1, 2]), np.array([1, 3]), np.array([3, 4])]
    vmask = [np.ones(3, bool), np.ones(2, bool), np.ones(2, bool)]


def test_failover_assignment_matches_reference(data):
    owner = np.array([0, 1, 1, 2, 0])
    new = recovery.failover_assignment(owner, 1, 3)
    assert not (new == 1).any()
    np.testing.assert_array_equal(new, j_rec.failover_assignment(owner, 1, 3))
    owner = np.array([0, 1, 2, 1, 2])
    new = recovery.failover_assignment(owner, 1, 3, book=_Book())
    np.testing.assert_array_equal(new, [0, 0, 2, 2, 2])
    np.testing.assert_array_equal(
        new, j_rec.failover_assignment(owner, 1, 3, book=_Book()))
    with pytest.raises(ValueError):
        recovery.failover_assignment(np.zeros(3, np.int64), 0, 1)
    # a real edge book: each package's own book, every worker dying
    jg, tg, *_ = data
    a = partition_edges(jg, 4, "hep100", seed=0)
    jbook, tbook = j_edge_book(jg, a, 4), build_edge_book(tg, a, 4)
    owner = tbook.master_assignment()
    np.testing.assert_array_equal(owner, jbook.master_assignment())
    for dead in range(4):
        for kw in ({}, {"book": None}):
            got = recovery.failover_assignment(
                owner, dead, 4, book=kw.get("book", tbook))
            expect = j_rec.failover_assignment(
                owner, dead, 4, book=kw.get("book", jbook))
            assert got.dtype == expect.dtype
            np.testing.assert_array_equal(got, expect)
            assert not (got == dead).any()


def test_serving_worker_death_matches_reference(data):
    """A worker dies at t=0.25 under 300 qps: both packages serve all 120
    requests, reroute the same ones and report the same modeled latencies
    and transition window."""
    jg, tg, feats, *_ = data
    feats = feats[:, :12]
    k, n = 4, 120
    a = partition_edges(jg, k, "hep100", seed=0)
    dims = dict(DIMS, feature_dim=12)
    jspec = jm.GNNSpec(model="sage", agg_backend="tiled", **dims)
    tspec = tm.GNNSpec(model="sage", agg_backend="tiled", **dims)
    jparams = jm.init_params(jspec, seed=2)
    tparams = tm.params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    jeng = j_inf.LayerwiseInference.build(jg, a, k, jspec, jparams, feats)
    teng = t_inf.LayerwiseInference.build(tg, a, k, tspec, tparams, feats,
                                          device=CPU)
    owner = jeng.book.master_assignment()
    rng = np.random.default_rng(5)
    req = rng.integers(0, jg.num_vertices, n)
    arr = np.sort(rng.uniform(0, n / 300.0, n))
    kw = dict(hops=1, fanout=8, max_batch=8, max_wait=5e-4, seed=0)
    je, jb, _ = j_build_serving(jg, j_vbook(jg, owner, k), jspec, jparams,
                                jeng.run(), **kw)
    te, tb, _ = build_serving(tg, build_vertex_book(tg, owner, k), tspec,
                              tparams, teng.run(), device=CPU, **kw)
    spec = ["worker-death@t:0.25,worker:1"]
    j_plan, plan = JPlan.parse(spec, seed=0), FaultPlan.parse(spec, seed=0)
    jrep = j_run_sim(je, jb, owner, req, arr, fault_plan=j_plan,
                     failover_owner=j_rec.failover_assignment(
                         owner, 1, k, book=jeng.book),
                     detect_delay=0.005)
    rep = run_serving_sim(te, tb, owner, req, arr, fault_plan=plan,
                          failover_owner=recovery.failover_assignment(
                              owner, 1, k, book=teng.book),
                          detect_delay=0.005)
    assert rep.served() == jrep.served() == n
    assert rep.dead_worker == jrep.dead_worker == 1
    assert rep.rerouted == jrep.rerouted > 0
    assert rep.transition_stats() == jrep.transition_stats()
    assert rep.transition_stats()["requests"] >= rep.rerouted
    np.testing.assert_array_equal(rep.latency, jrep.latency)
    np.testing.assert_array_equal(rep.arrival, jrep.arrival)
    np.testing.assert_array_equal(rep.batch_worker, jrep.batch_worker)
    assert rep.served(1) < (np.asarray(owner)[req] == 1).sum()
    assert sorted(rep.served_ids.tolist()) == sorted(req.tolist())
    assert rep.logits.shape == (n, DIMS["num_classes"])
    assert plan.injected_count == plan.handled_count == 1
    assert j_plan.injected_count == j_plan.handled_count == 1
    # without a failover map the death cannot be served
    with pytest.raises(ValueError, match="failover_owner"):
        run_serving_sim(te, tb, owner, req, arr,
                        fault_plan=FaultPlan.parse(spec, seed=0))


# ----------------------------------------------------------------- (g) CLIs
TINY = ["--device", "cpu", "--graph", "OR", "--scale", "0.02", "--k", "4",
        "--features", "8", "--hidden", "8", "--classes", "4", "--layers", "2"]


@pytest.mark.parametrize("cli", ["train", "serve"])
def test_cli_unknown_fault_spec_exits_1(cli, capsys):
    run = gnn_train.run if cli == "train" else gnn_serve.run
    with pytest.raises(SystemExit) as ei:
        run(TINY + ["--inject-fault", "explode@step:1"])
    assert ei.value.code == 1
    out = capsys.readouterr().out
    assert "bad --inject-fault" in out and "valid kinds" in out


def test_main_exits_3_on_an_injected_crash(tmp_path, capsys):
    d = str(tmp_path / "ck")
    with pytest.raises(SystemExit) as ei:
        gnn_train.main(TINY + ["--epochs", "3", "--ckpt-dir", d,
                               "--inject-fault", "crash@step:1"])
    assert ei.value.code == gnn_train.CRASH_EXIT == 3
    out = capsys.readouterr().out
    assert "FATAL" in out and "--resume" in out
    assert checkpoint_extra(d)[0] == 0


@pytest.mark.parametrize("regime", ["minibatch", "fullbatch int8"])
def test_cli_crash_resume_ends_on_the_uninterrupted_loss(tmp_path, regime):
    """A run crashed at step 3 and resumed with --resume (here through a
    corrupt newest checkpoint, step 2: restore falls back to step 1)
    trains the uninterrupted run's remaining steps bit for bit and ends on
    its final loss and parameters exactly. Mini batch: scale 0.02, batch
    64, 2 steps an epoch; full batch: int8 with its EF carry."""
    crash = "crash@step:3"
    if regime == "minibatch":
        common = TINY + ["--regime", "minibatch", "--partitioner", "metis",
                         "--k", "2", "--epochs", "2", "--batch", "64",
                         "--classes", "8"]
    else:
        common = TINY + ["--epochs", "4", "--codec", "int8"]
    oracle = gnn_train.run(common)
    d = str(tmp_path / "ck")
    with pytest.raises(WorkerCrash):
        gnn_train.run(common + ["--ckpt-dir", d, "--inject-fault", crash])
    out = gnn_train.run(common + ["--ckpt-dir", d, "--resume",
                                  "--inject-fault", "corrupt-ckpt"])
    assert out.checkpoints.resumed_from == 1 and out.start_step == 2
    assert out.losses == oracle.losses[2:]
    assert out.losses[-1] == oracle.losses[-1]
    assert out.fault_plan.injected_count == out.fault_plan.handled_count == 1
    assert out.checkpoints.nbytes > 0
    assert out.checkpoints.restore_seconds is not None
    assert _bitwise(_params(out.trainer), _params(oracle.trainer))


def test_cli_fullbatch_resume_at_the_defaults_is_bitwise(tmp_path):
    """The full-batch CLI at its defaults (scatter backend, fp32, halo),
    crashed at epoch 2 and resumed from the epoch-1 checkpoint: epochs 2-4
    and the final parameters are the uninterrupted run's, bit for bit, as
    the reference pins for its trainer (tests/test_fault.py). The step
    runs under `minibatch.repeatable_step` itself; nothing here sets
    PyTorch's deterministic mode, and the process's setting is untouched
    after each run."""
    common = ["--device", "cpu", "--graph", "OR", "--scale", "0.02",
              "--k", "4", "--features", "16", "--hidden", "8",
              "--epochs", "5"]
    assert not torch.are_deterministic_algorithms_enabled()
    oracle = gnn_train.run(common)
    assert not torch.are_deterministic_algorithms_enabled()
    d = str(tmp_path / "ck")
    with pytest.raises(WorkerCrash):
        gnn_train.run(common + ["--ckpt-dir", d, "--inject-fault",
                                "crash@step:2"])
    out = gnn_train.run(common + ["--ckpt-dir", d, "--resume"])
    assert out.trainer.spec.agg_backend == "scatter"
    assert out.trainer.sync_mode == "halo" and out.trainer.codec == "fp32"
    assert out.checkpoints.resumed_from == 1 and out.start_step == 2
    assert out.losses == oracle.losses[2:]
    assert _bitwise(_params(out.trainer), _params(oracle.trainer))
    for moment in ("mu", "nu"):
        a, b = (getattr(t.opt_state, moment)["layers"]
                for t in (out.trainer, oracle.trainer))
        assert _bitwise([x for lay in a for x in lay.values()],
                        [x for lay in b for x in lay.values()])
    assert not torch.are_deterministic_algorithms_enabled()


def test_serve_cli_worker_death_answers_every_request(capsys):
    out = gnn_serve.run(TINY + ["--smoke", "--qps", "100", "--inject-fault",
                                "worker-death@t:1.0,worker:1",
                                "--detect-delay", "0.005"])
    rep = out.report
    assert rep.served() == 200 and rep.dead_worker == 1 and rep.rerouted > 0
    assert out.fault_plan.injected_count == out.fault_plan.handled_count == 1
    text = capsys.readouterr().out
    assert "replica-aware" in text and "every request answered: True" in text

"""The port's mini-batch training slice against the JAX package's, on the CPU.

The reference's own small sizes (tests/test_pipeline.py): OR 0.02, metis,
k=4, features 16, hidden 8, 2 layers, 5 classes, global batch 32. The JAX
tiled backend runs its jnp oracle off-TPU.

  (a) the port's `BatchPreparer` draws the reference's batches bit for bit
      (every stacked host array and the fetch accounting), and its
      `start_step` fast-forward lands on the same batch
  (b) `MiniBatchTrainer` 5-step loss trajectories == the reference
      trainer's within 1e-4 a step, sage/gcn/gat x scatter/tiled; the first
      step's gradients at rtol=atol=2e-4
  (c) overlapped == serial bit for bit within the port (batches, losses)
  (d) the pipeline's phase accounting, rebalancing, lifecycle and errors,
      and the cache's transparency
  (e) the repeatable step leaves the process's deterministic setting as it
      found it
  (f) `gnn_train --regime minibatch` trains on the CPU and refuses the
      other regime's partitioners
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.graph import paper_graph as j_paper_graph  # noqa: E402
from repro.core.vertex_partition import partition_vertices  # noqa: E402
from repro.gnn import minibatch as j_mb  # noqa: E402
from repro.gnn.models import GNNSpec as JSpec  # noqa: E402
from repro_torch.core.graph import paper_graph  # noqa: E402
from repro_torch.fault import FaultInjector, FaultPlan  # noqa: E402
from repro_torch.gnn import minibatch as t_mb  # noqa: E402
from repro_torch.gnn.models import GNNSpec as TSpec  # noqa: E402
from repro_torch.launch import gnn_train  # noqa: E402
from repro_torch.optim import leaves  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_gnn_distributed.py:38
LOSS_TOL = 1e-4                   # tests/test_gnn_distributed.py:53
DIMS = dict(feature_dim=16, hidden_dim=8, num_classes=5, num_layers=2)
SEED = 3
STEPS = 5
MODELS = ["sage", "gcn", "gat"]
BACKENDS = ["scatter", "tiled"]


@pytest.fixture(scope="module")
def data():
    """Both packages' OR 0.02 graphs, the node data of tests/conftest.py
    and one metis partition."""
    jg = j_paper_graph("OR", scale=0.02, seed=0)
    tg = paper_graph("OR", scale=0.02, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(jg.num_vertices, 16)).astype(np.float32)
    labels = rng.integers(0, 5, jg.num_vertices).astype(np.int32)
    train = rng.random(jg.num_vertices) < 0.3
    assignment = partition_vertices(jg, 4, "metis", seed=0)
    return jg, tg, feats, labels, train, assignment


def _port(data, model="sage", backend="scatter", **kw):
    _, tg, feats, labels, train, a = data
    spec = TSpec(model=model, agg_backend=backend, **DIMS)
    return t_mb.MiniBatchTrainer.build(
        tg, a, 4, spec, feats, labels, train, device=CPU, global_batch=32,
        seed=SEED, **kw)


def _ref(data, model="sage", backend="scatter", **kw):
    jg, _, feats, labels, train, a = data
    spec = JSpec(model=model, agg_backend=backend, **DIMS)
    return j_mb.MiniBatchTrainer.build(
        jg, a, 4, spec, feats, labels, train, global_batch=32, seed=SEED,
        **kw)


@pytest.fixture(scope="module")
def reference(data):
    """The reference trainer's 5-step losses and first-step (loss, grads)
    on its first batch, built once per (model, backend)."""
    cache = {}

    def get(model, backend):
        if (model, backend) not in cache:
            tr = _ref(data, model, backend)
            pb, _ = tr.engine.next_batch()
            sizes = tuple(p.n_dst for p in tr.plan.layers)

            def loss_of(params):
                return jnp.mean(jax.vmap(
                    lambda b: j_mb.minibatch_loss(tr.spec, params, b, sizes),
                    axis_name=j_mb.AXIS)(pb.stacked))

            loss, grads = jax.value_and_grad(loss_of)(tr.params)
            tr.close()
            tr = _ref(data, model, backend)
            losses = [tr.train_step().loss for _ in range(STEPS)]
            tr.close()
            cache[model, backend] = (losses, float(loss),
                                     jax.tree.map(np.asarray, grads))
        return cache[model, backend]

    return get


def _flat(stacked) -> dict:
    out = {k: v for k, v in stacked.items() if k != "layers"}
    for li, lay in enumerate(stacked["layers"]):
        out.update({f"layers[{li}].{k}": v for k, v in lay.items()})
    return out


# ------------------------------------------------------------- (a) batches
@pytest.mark.parametrize("backend", BACKENDS)
def test_batches_match_reference_bitwise(data, backend):
    jt, tt = _ref(data, backend=backend), _port(data, backend=backend)
    try:
        for step in range(4):
            jpb, _ = jt.engine.next_batch()
            tpb, _ = tt.engine.next_batch()
            assert jpb.index == tpb.index == step
            ref, port = _flat(jpb.stacked), _flat(tpb.host)
            assert ref.keys() == port.keys()
            assert ("layers[0].agg_ldst" in port) == (backend == "tiled")
            for name, a in ref.items():
                a = np.asarray(a)
                assert a.dtype == port[name].dtype, name
                np.testing.assert_array_equal(port[name], a, err_msg=name)
            assert tpb.fetch_stats == jpb.fetch_stats
            for name in ("input_vertices", "remote_vertices", "edges"):
                np.testing.assert_array_equal(getattr(tpb, name),
                                              getattr(jpb, name))
            # the device tree: index arrays int64, pad esrc clamped to the
            # last source row (JAX's gather clamps), the rest as sampled
            dev = _flat(tpb.stacked)
            assert any((port[f"layers[{li}].esrc"] == pad.n_src).any()
                       for li, pad in enumerate(tt.plan.layers))  # pad edges
            for li, pad in enumerate(tt.plan.layers):
                esrc = port[f"layers[{li}].esrc"]
                np.testing.assert_array_equal(
                    dev[f"layers[{li}].esrc"].numpy(),
                    np.minimum(esrc, pad.n_src - 1))
            for name, t in dev.items():
                assert t.dtype == (torch.int64 if name.split(".")[-1] in
                                   ("esrc", "edst", "agg_order")
                                   else torch.from_numpy(port[name]).dtype)
                if not name.endswith("esrc"):
                    np.testing.assert_array_equal(t.numpy(), port[name])
    finally:
        jt.close()
        tt.close()


def test_start_step_fast_forwards_to_the_same_batch(data):
    fresh, resumed = _port(data), _port(data, start_step=2)
    for _ in range(3):
        want, _ = fresh.engine.next_batch()
    got, _ = resumed.engine.next_batch()
    assert got.index == want.index == 2
    for name, a in _flat(want.host).items():
        np.testing.assert_array_equal(_flat(got.host)[name], a, err_msg=name)


# --------------------------------------------------------- (b) trajectories
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_loss_trajectory_matches_reference(data, reference, model, backend):
    want = reference(model, backend)[0]
    tr = _port(data, model, backend)
    got = [tr.train_step().loss for _ in range(STEPS)]
    tr.close()
    assert len(got) == STEPS and np.isfinite(got).all()
    diff = max(abs(a - b) for a, b in zip(got, want))
    assert diff < LOSS_TOL, (got, want)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_first_step_grads_match_reference(data, reference, model, backend):
    """The reference's gradient of the mean of k psum'd worker losses is
    the gradient of the one global loss (no factor k): the port's single
    division over the summed (loss sum, count) pairs gives it."""
    _, want_loss, want = reference(model, backend)
    tr = _port(data, model, backend)
    pb, _ = tr.engine.next_batch()
    tr.close()
    params = {"layers": [{n: t.detach().requires_grad_() for n, t in
                          layer.items()} for layer in tr.params["layers"]]}
    loss = t_mb.minibatch_loss(tr.spec, params, pb.stacked,
                               [p.n_dst for p in tr.plan.layers])
    grads = torch.autograd.grad(loss, leaves(params))
    np.testing.assert_allclose(float(loss.detach()), want_loss, **TOL)
    it = iter(grads)
    for li, layer in enumerate(params["layers"]):
        for name in layer:
            np.testing.assert_allclose(next(it).numpy(),
                                       want["layers"][li][name],
                                       err_msg=f"layer {li} {name}", **TOL)


# ---------------------------------------------------------------- (c) overlap
def test_overlap_batches_bitwise_identical_to_serial(data):
    serial = _port(data, backend="tiled")
    overlap = _port(data, backend="tiled", overlap=True, prefetch_depth=3)
    try:
        for _ in range(4):
            pb_s, _ = serial.engine.next_batch()
            pb_o, _ = overlap.engine.next_batch()
            assert pb_s.index == pb_o.index
            for name, a in _flat(pb_s.host).items():
                np.testing.assert_array_equal(_flat(pb_o.host)[name], a,
                                              err_msg=name)
            for name, t in _flat(pb_s.stacked).items():
                assert torch.equal(_flat(pb_o.stacked)[name], t), name
            assert pb_s.fetch_stats == pb_o.fetch_stats
    finally:
        serial.close()
        overlap.close()


@pytest.mark.parametrize("model", ["sage", "gat"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_overlap_loss_trajectory_matches_serial(data, model, backend):
    losses = {}
    for overlap in (False, True):
        tr = _port(data, model, backend, overlap=overlap)
        losses[overlap] = [tr.train_step().loss for _ in range(STEPS)]
        tr.close()
    assert losses[True] == losses[False]


# ------------------------------------------------ (d) pipeline and the store
def test_serial_phase_accounting_covers_wall(data):
    tr = _port(data)
    tr.train_step()
    for _ in range(2):
        m = tr.train_step()
        phases = (m.sample_time_host + m.fetch_time_host
                  + m.transfer_time_host + m.compute_time_host)
        assert phases >= m.step_wall_host * (1 - 1e-9)
        assert min(m.sample_time_host, m.fetch_time_host,
                   m.transfer_time_host, m.compute_time_host) > 0.0
        assert m.overlap_efficiency == 0.0 and not m.overlap
        assert m.queue_wait_host == m.host_time
    tr.close()


def test_overlap_hides_host_time_in_steady_state(data):
    tr = _port(data, overlap=True, prefetch_depth=2)
    tr.train_step()
    ms = [tr.train_step() for _ in range(6)]
    tr.close()
    for m in ms:
        assert m.overlap and 0.0 <= m.overlap_efficiency <= 1.0
        assert m.host_time > 0.0
    assert sum(max(m.host_time - m.queue_wait_host, 0.0) for m in ms) > 0.0


def test_rebalance_composes_with_overlap(data):
    """Delayed-feedback seed shares: steps keep running and the share
    vector the trainer publishes reaches the producer."""
    tr = _port(data, overlap=True, rebalance=True)
    ms = [tr.train_step() for _ in range(4)]
    share = tr._seed_share.copy()
    engine_share = tr.engine._current_share()
    tr.close()
    assert all(np.isfinite(m.loss) for m in ms)
    assert not np.allclose(share, 0.25)  # the loads moved it
    np.testing.assert_allclose(engine_share, share)


def test_engine_rejects_bad_depth(data):
    with pytest.raises(ValueError):
        _port(data, overlap=True, prefetch_depth=0).engine


def test_engine_close_is_idempotent(data):
    tr = _port(data, overlap=True)
    tr.train_step()
    tr.close()
    tr.close()
    assert not tr.engine._producer.is_alive()


@pytest.mark.parametrize("overlap", [False, True])
def test_next_batch_after_close_raises(data, overlap):
    tr = _port(data, overlap=overlap)
    tr.engine.next_batch()
    tr.close()
    with pytest.raises(RuntimeError, match="closed"):
        tr.engine.next_batch()


def test_producer_error_surfaces_in_consumer(data):
    tr = _port(data, overlap=True, prefetch_depth=1)
    engine = tr.engine
    engine.next_batch()
    boom = ValueError("sampler exploded")

    def bad_prepare(*a, **kw):
        raise boom

    engine.preparer.prepare = bad_prepare
    with pytest.raises(RuntimeError) as ei:
        for _ in range(8):  # drain whatever was prefetched before the crash
            engine.next_batch()
    assert ei.value.__cause__ is boom
    tr.close()


def test_loss_identical_across_cache_policies(data):
    """The cache is transparent: which store serves a row never changes
    it, so every policy trains bit for bit alike; the hits differ."""
    runs = {}
    for policy in ("none", "random", "degree", "halo"):
        tr = _port(data, cache_policy=policy, cache_budget=60)
        ms = [tr.train_step() for _ in range(3)]
        tr.close()
        runs[policy] = ([m.loss for m in ms],
                        sum(int(m.cache_hits.sum()) for m in ms))
        for m in ms:
            np.testing.assert_array_equal(
                m.cache_hits + m.remote_misses, m.remote_vertices)
            np.testing.assert_array_equal(m.wire_bytes, m.miss_bytes)
    assert all(r[0] == runs["none"][0] for r in runs.values())
    assert runs["none"][1] == 0 and runs["halo"][1] > 0


def test_unported_options_are_refused(data):
    """Nothing of `build` is refused now: the codecs are ported (int8
    builds, and its store ships int8 rows), and so is fault injection (an
    injector reaches the batch preparer, which sets its worker count)."""
    assert _port(data, codec="int8").store.codec.name == "int8"
    injector = FaultInjector(FaultPlan([]))
    tr = _port(data, injector=injector)
    try:
        assert tr.engine.preparer.injector is injector and injector.k == 4
        assert tr.train_step().loss > 0
    finally:
        tr.close()


# ------------------------------------------------------- (e) repeatable step
@pytest.mark.parametrize("repeatable", [True, False])
def test_repeatable_step_is_scoped_to_the_step(data, repeatable):
    seen = []

    def probe(spec, params, stacked, sizes):
        seen.append(torch.are_deterministic_algorithms_enabled())
        return real(spec, params, stacked, sizes)

    real = t_mb.minibatch_loss
    before = torch.are_deterministic_algorithms_enabled()
    tr = _port(data, repeatable=repeatable)
    try:
        t_mb.minibatch_loss = probe
        tr.train_step()
        # a step that raises restores the setting too
        t_mb.minibatch_loss = lambda *a: 1 / 0
        with pytest.raises(ZeroDivisionError):
            tr.train_step()
    finally:
        t_mb.minibatch_loss = real
        tr.close()
    assert seen == [repeatable]
    assert torch.are_deterministic_algorithms_enabled() == before


# ---------------------------------------------------------------- (f) CLI
TINY = ["--graph", "OR", "--scale", "0.02", "--k", "4", "--features", "16",
        "--hidden", "8", "--classes", "5", "--layers", "2", "--device", "cpu",
        "--regime", "minibatch", "--partitioner", "metis", "--batch", "64"]


@pytest.mark.parametrize("overlap", [False, True])
def test_cli_minibatch_trains_on_cpu(capsys, overlap):
    argv = TINY + ["--model", "gat", "--agg-backend", "tiled", "--epochs",
                   "2"] + (["--overlap"] if overlap else [])
    out = gnn_train.run(argv)
    train_count = int(sum(p.shape[0] for p in
                          out.trainer.train_vertices_per_worker))
    steps = 2 * max(train_count // 64, 1)
    assert out.trainer.lr == 1e-3 and out.trainer.overlap == overlap
    assert len(out.losses) == len(out.step_seconds) == steps
    assert len(out.step_metrics) == steps and np.isfinite(out.losses).all()
    assert out.peak_memory is None  # a device number only on the card
    assert out.estimate.step_time > 0
    text = capsys.readouterr().out
    for line in ("partitioned in", "edge_cut=", "remote/step", "hit_rate",
                 "cluster step est", "(modeled)", "warm step", "sample ",
                 "fetch ", "transfer ", "epoch   1 loss"):
        assert line in text, line
    assert ("overlap_eff" in text) == overlap


def test_cli_minibatch_matches_trainer_api(data):
    """The CLI's run is the trainer's: same data draw, partition and seed
    give the same losses as `MiniBatchTrainer` built by hand."""
    out = gnn_train.run(TINY + ["--model", "sage", "--epochs", "1"])
    g = paper_graph("OR", scale=0.02, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(g.num_vertices, 16)).astype(np.float32)
    labels = rng.integers(0, 5, g.num_vertices).astype(np.int32)
    train = rng.random(g.num_vertices) < 0.3
    np.testing.assert_array_equal(out.assignment, partition_vertices(
        g, 4, "metis", seed=0, train_mask=train))
    tr = t_mb.MiniBatchTrainer.build(
        g, out.assignment, 4, dataclasses.replace(out.spec), feats, labels,
        train, device=CPU, global_batch=64, seed=0)
    want = [tr.train_step().loss for _ in out.losses]
    tr.close()
    assert out.losses == want


@pytest.mark.parametrize("regime,partitioner", [("minibatch", "hep100"),
                                                ("fullbatch", "metis")])
def test_cli_refuses_the_other_regimes_partitioners(regime, partitioner):
    argv = [a for a in TINY if a not in ("minibatch", "metis")]
    argv = [a for a in argv if a not in ("--regime", "--partitioner")]
    with pytest.raises(ValueError, match="partitioners"):
        gnn_train.run(argv + ["--regime", regime, "--partitioner",
                              partitioner])

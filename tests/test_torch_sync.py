"""The port's Dense and Ring (1.5D) sync against the JAX package's, on the CPU.

Same numpy inputs through both packages, at the reference's own sizes
(OR 0.02, features 16, hidden 8, 2 layers, 5 classes, seed 7;
tests/test_ring.py:117-186, tests/test_gnn_distributed.py:25-55). The JAX
trainers run their tiled backend (off-TPU the jnp oracle under its
`custom_vjp`s); both of the port's backends are held to it.

  (a) `build_blockrow_book` == the reference's bit for bit, k in {1, 3, 4},
      with and without the tiled layout
  (b) forward logits, dense (hep100 and random partitions) and ring at
      k in {1, 4}, == the JAX trainer's at rtol=atol=2e-4
  (c) `loss_fn` gradients at k=4, dense and ring, gat and sage, tiled,
      == the reference's vmap gradients at 2e-4
  (d) 3-step trajectories, dense and ring, within 1e-4 of the reference's;
      within the port ring == halo == the k=1 oracle within 1e-4, and ring
      tiled == ring scatter (1e-6 on the loss, 1e-5 on the logits)
  (e) `make_sync`'s errors; the dense and ring byte and cost accounting ==
      the reference's bit for bit
  (f) `gnn_train --sync-mode ring|dense` trains on the CPU (ring on the
      blockrow layout); `LayerwiseInference(sync_mode="dense")` == the
      reference's
  (g) no completion (halo, dense, ring) issues a scatter whose real
      destination rows repeat: on the card such adds land in atomic order;
      the sum completions and halo's broadcast write no pad slot

The reference cannot differentiate its dense GAT (`DenseSync.reduce_max`
takes `lax.pmax` before GAT's stop_gradient, and `pmax` has no
differentiation rule), so dense GAT's gradients and trajectory are held to
the reference's halo trainer on the same book: the same function of the
graph, which the reference's own tests hold equal to dense in the forward.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cost_model as j_cost  # noqa: E402
from repro.core import partition_book as j_book  # noqa: E402
from repro.core.edge_partition import partition_edges  # noqa: E402
from repro.core.graph import paper_graph as j_paper_graph  # noqa: E402
from repro.gnn import fullbatch as j_fb  # noqa: E402
from repro.gnn import inference as j_inf  # noqa: E402
from repro.gnn import models as jm  # noqa: E402
from repro.gnn import sync as j_sync  # noqa: E402
from repro_torch.core import cost_model as t_cost  # noqa: E402
from repro_torch.core import partition_book as t_book  # noqa: E402
from repro_torch.core.graph import paper_graph  # noqa: E402
from repro_torch.gnn import fullbatch as t_fb  # noqa: E402
from repro_torch.gnn import inference as t_inf  # noqa: E402
from repro_torch.gnn import models as tm  # noqa: E402
from repro_torch.gnn import sync as t_sync  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import gnn_train  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_gnn_distributed.py:38
DIMS = dict(feature_dim=16, hidden_dim=8, num_classes=5, num_layers=2)
SEED = 7
STEPS = 3
MODELS = ["sage", "gcn", "gat"]
BACKENDS = ["scatter", "tiled"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(port, ref, **tol):
    assert len(port["layers"]) == len(ref["layers"])
    for li, (pl, rl) in enumerate(zip(port["layers"], ref["layers"])):
        assert pl.keys() == rl.keys()
        for name in rl:
            np.testing.assert_allclose(pl[name], rl[name],
                                       err_msg=f"layer {li} {name}", **tol)


@pytest.fixture(scope="module")
def data():
    jg = j_paper_graph("OR", scale=0.02, seed=0)
    tg = paper_graph("OR", scale=0.02, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(tg.num_vertices, DIMS["feature_dim"])).astype(
        np.float32)
    labels = rng.integers(0, DIMS["num_classes"], tg.num_vertices).astype(
        np.int32)
    train = rng.random(tg.num_vertices) < 0.3
    parts = {m: partition_edges(jg, 4, m, seed=1) for m in ("hep100", "random")}
    return jg, tg, feats, labels, train, parts


def _port_trainer(data, model, backend, sync_mode, k=4, method="hep100"):
    _, tg, feats, labels, train, parts = data
    assignment = (None if sync_mode == "ring"
                  else np.zeros(tg.num_edges, np.int32) if k == 1
                  else parts[method])
    spec = tm.GNNSpec(model=model, agg_backend=backend, **DIMS)
    return t_fb.FullBatchTrainer.build(tg, assignment, k, spec, feats, labels,
                                       train, sync_mode=sync_mode, seed=SEED,
                                       device=CPU)


def _ref_mode(mode, model):
    return "halo" if (mode, model) == ("dense", "gat") else mode


@pytest.fixture(scope="module")
def reference(data):
    """Per (sync mode, model), built once at k=4 (hep100 for dense): the
    JAX trainer's forward logits at its initial parameters, its vmap loss
    and gradients there (gat and sage), and its 3-step loss trajectory."""
    jg, _, feats, labels, train, parts = data
    cache = {}

    def get(mode, model):
        if (mode, model) not in cache:
            rmode = _ref_mode(mode, model)
            spec = jm.GNNSpec(model=model, agg_backend="tiled", **DIMS)
            tr = j_fb.FullBatchTrainer.build(
                jg, None if rmode == "ring" else parts["hep100"], 4, spec,
                feats, labels, train, sync_mode=rmode, seed=SEED)
            out = dict(logits=tr.forward_logits_global())
            if model in ("gat", "sage"):
                loss, _ = j_fb.make_step_fns(spec, rmode, jg.num_vertices, 4)
                mapped = j_fb.wrap_spmd(loss, 4, "sim")
                loss0, grads = jax.jit(jax.value_and_grad(
                    lambda p, b: jnp.mean(mapped(p, b))))(tr.params,
                                                          tr.blocks)
                out.update(loss0=float(loss0), grads=_np(grads))
            out["losses"] = [tr.train_step() for _ in range(STEPS)]
            cache[mode, model] = out
        return cache[mode, model]

    return get


# ------------------------------------------------------------- (a) the book
@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_blockrow_book_identical(data, k, tiled):
    jg, tg = data[:2]
    jb = j_book.build_blockrow_book(jg, k, tiled_layout=tiled)
    tb = t_book.build_blockrow_book(tg, k, tiled_layout=tiled)
    assert type(tb).__name__ == "BlockRowBook"
    for name in ("k", "num_vertices", "v_block", "c_max"):
        assert getattr(jb, name) == getattr(tb, name), name
    for name in ("vglobal", "vmask", "degree", "chunk_esrc", "chunk_edst",
                 "chunk_emask", "chunk_agg_order", "chunk_agg_ldst", "master"):
        a, b = getattr(jb, name), getattr(tb, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tb.chunk_agg_order.shape[-1] > 0) == tiled
    feats = data[2]
    np.testing.assert_array_equal(jb.local_features(feats),
                                  tb.local_features(feats))
    np.testing.assert_array_equal(jb.local_labels(data[3]),
                                  tb.local_labels(data[3]))
    local = np.random.default_rng(k).normal(size=(k, jb.v_block + 1, 3))
    np.testing.assert_array_equal(jb.scatter_to_global(local),
                                  tb.scatter_to_global(local))


# --------------------------------------------------------- (b) the forward
CONFIGS = [("dense", 4, "hep100"), ("dense", 4, "random"), ("ring", 4, None),
           ("ring", 1, None)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mode,k,method", CONFIGS)
def test_forward_logits_match_reference(data, reference, mode, k, method,
                                        model, backend):
    """Every configuration is held to the reference's k=4 trainer of its
    mode: the global logits are a function of the graph, not of the
    partition (the reference's invariant, tests/test_ring.py:115)."""
    tr = _port_trainer(data, model, backend, mode, k=k, method=method)
    book_type = "BlockRowBook" if mode == "ring" else "EdgePartitionBook"
    assert type(tr.book).__name__ == book_type
    got = tr.forward_logits_global()
    assert got.shape == (data[1].num_vertices, DIMS["num_classes"])
    np.testing.assert_allclose(got, reference(mode, model)["logits"], **TOL)


# ------------------------------------------------------ (c) loss gradients
@pytest.mark.parametrize("model", ["gat", "sage"])
@pytest.mark.parametrize("mode", ["dense", "ring"])
def test_loss_grads_match_reference_k4(data, reference, mode, model):
    ref = reference(mode, model)
    tr = _port_trainer(data, model, "tiled", mode)
    loss_of, _ = t_fb.make_step_fns(tr.spec, mode, 4)
    params = {"layers": [{n: t.clone().requires_grad_()
                          for n, t in layer.items()}
                         for layer in tr.params["layers"]]}
    loss = loss_of(params, tr.blocks)
    assert loss.dim() == 0
    leaves = [t for layer in params["layers"] for t in layer.values()]
    it = iter(torch.autograd.grad(loss, leaves))
    grads = {"layers": [{n: next(it).numpy() for n in layer}
                        for layer in params["layers"]]}
    assert abs(float(loss.detach()) - ref["loss0"]) < 1e-5
    _assert_trees_close(grads, ref["grads"], **TOL)


# ---------------------------------------------------------- (d) training
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("mode", ["dense", "ring"])
def test_trajectory_matches_reference(data, reference, mode, model, backend):
    ref = reference(mode, model)["losses"]
    tr = _port_trainer(data, model, backend, mode)
    losses = [tr.train_step() for _ in range(STEPS)]
    for step, (a, b) in enumerate(zip(losses, ref)):
        assert abs(a - b) < 1e-4, (step, a, b)


@pytest.mark.parametrize("model", MODELS)
def test_ring_equals_halo_and_single_within_port(data, model):
    """tests/test_ring.py:135 in the port: 3 steps of ring, halo and the
    k=1 oracle, |dloss| < 1e-4 a step."""
    single = _port_trainer(data, model, "tiled", "local", k=1)
    halo = _port_trainer(data, model, "tiled", "halo")
    ring = _port_trainer(data, model, "tiled", "ring")
    for step in range(STEPS):
        l1, lh, lr = single.train_step(), halo.train_step(), ring.train_step()
        assert abs(l1 - lr) < 1e-4, (step, l1, lr)
        assert abs(lh - lr) < 1e-4, (step, lh, lr)


@pytest.mark.parametrize("model", MODELS)
def test_ring_tiled_equals_scatter(data, model):
    """tests/test_ring.py:168 in the port: two steps on each backend, the
    last losses within 1e-6, the logits after them within 1e-5."""
    outs = {}
    for backend in BACKENDS:
        tr = _port_trainer(data, model, backend, "ring")
        losses = [tr.train_step() for _ in range(2)]
        outs[backend] = (losses, tr.forward_logits_global())
    assert abs(outs["tiled"][0][-1] - outs["scatter"][0][-1]) < 1e-6
    np.testing.assert_allclose(outs["tiled"][1], outs["scatter"][1],
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------- (e) surface, bytes
def test_make_sync_errors(data):
    with pytest.raises(ValueError) as exc:
        t_sync.make_sync("allgather", None)
    for mode in ("local", "dense", "halo", "ring"):
        assert mode in str(exc.value)
    assert t_sync.SYNC_MODES == j_sync.SYNC_MODES
    halo = _port_trainer(data, "sage", "scatter", "halo")
    with pytest.raises(TypeError, match="RingBlock"):
        t_sync.make_sync("ring", halo.blocks)
    ring = _port_trainer(data, "sage", "scatter", "ring")
    assert isinstance(t_sync.make_sync("ring", ring.blocks), t_sync.RingSync)
    with pytest.raises(TypeError, match="BlockRowBook"):
        t_sync.sync_bytes_per_round(halo.book, 8, "ring")
    with pytest.raises(ValueError):
        t_fb.build_book(data[1], None, 4, sync_mode="allgather")


@pytest.mark.parametrize("model", ["sage", "gat"])
@pytest.mark.parametrize("k", [1, 4])
def test_ring_accounting_identical(data, k, model):
    """Per-round bytes at every width, the trainer's epoch bytes and
    per-partition memory, and `fullbatch_epoch` on a BlockRowBook ==
    the reference's bit for bit."""
    jg, tg, feats, labels, train, _ = data
    jspec = jm.GNNSpec(model=model, **DIMS)
    tspec = tm.GNNSpec(model=model, **DIMS)
    jt = j_fb.FullBatchTrainer.build(jg, None, k, jspec, feats, labels, train,
                                     sync_mode="ring", seed=0)
    tt = t_fb.FullBatchTrainer.build(tg, None, k, tspec, feats, labels, train,
                                     sync_mode="ring", seed=0, device=CPU)
    for d in (1, 4, 16, 516):
        want = j_sync.sync_bytes_per_round(jt.book, d, "ring")
        assert t_sync.sync_bytes_per_round(tt.book, d, "ring") == want
        assert t_sync.ring_bytes_per_round(tt.book, d) == want
        assert t_cost.ring_bytes_per_round(tt.book, d) == (
            j_cost.ring_bytes_per_round(jt.book, d))
    assert jspec.aggregate_dims("ring") == tspec.aggregate_dims("ring")
    assert jt.comm_bytes_per_epoch() == tt.comm_bytes_per_epoch()
    a, b = jt.memory_bytes_per_partition(), tt.memory_bytes_per_partition()
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)
    je = j_cost.fullbatch_epoch(jt.book, jspec)
    te = t_cost.fullbatch_epoch(tt.book, tspec)
    assert je.epoch_time == te.epoch_time and je.oom == te.oom
    for name in ("compute_time", "comm_time", "comm_bytes", "memory",
                 "wire_bytes"):
        np.testing.assert_array_equal(getattr(je, name), getattr(te, name),
                                      err_msg=name)


# ------------------------------------------------------ (f) CLI, inference
TINY = ["--graph", "OR", "--scale", "0.02", "--k", "4", "--features", "8",
        "--hidden", "8", "--classes", "4", "--layers", "2", "--device",
        "cpu", "--epochs", "6", "--lr", "0.02"]


@pytest.mark.parametrize("mode", ["dense", "ring"])
def test_cli_trains_sync_mode_on_cpu(mode, capsys):
    out = gnn_train.run(TINY + ["--sync-mode", mode, "--model", "gat",
                                "--agg-backend", "tiled"])
    assert out.trainer.sync_mode == mode
    assert len(out.losses) == 6 and all(np.isfinite(out.losses))
    assert out.losses[-1] < out.losses[0]
    assert out.estimate.epoch_time > 0
    text = capsys.readouterr().out
    book = "BlockRowBook" if mode == "ring" else "EdgePartitionBook"
    assert type(out.trainer.book).__name__ == book
    assert ("(blockrow)" in text) == (mode == "ring")
    assert "paper-cluster epoch estimate" in text


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_layerwise_inference_dense_matches_reference(data, model):
    jg, tg, feats, _, _, parts = data
    jspec = jm.GNNSpec(model=model, agg_backend="tiled", **DIMS)
    tspec = tm.GNNSpec(model=model, agg_backend="tiled", **DIMS)
    jparams = jm.init_params(jspec, seed=SEED)
    tparams = tm.params_from_numpy(_np(jparams), CPU)
    a = parts["hep100"]
    expect = j_inf.LayerwiseInference.build(jg, a, 4, jspec, jparams, feats,
                                            sync_mode="dense")
    eng = t_inf.LayerwiseInference.build(tg, a, 4, tspec, tparams, feats,
                                         device=CPU, sync_mode="dense")
    for li, (x, y) in enumerate(zip(eng.run(), expect.run())):
        np.testing.assert_allclose(x, y, err_msg=f"layer {li}", **TOL)
    assert eng.sync_bytes() == expect.sync_bytes()


# ----------------------------------- (g) completions in no atomic order
SCATTERS = ("index_add_", "index_add", "scatter_reduce_", "scatter_add_",
            "index_put_", "__setitem__")


def _record_scatters(monkeypatch, calls):
    """Record (destination rows, destination row index) of every scatter
    a torch.Tensor method issues while the patch is on."""
    for name in SCATTERS:
        inner = getattr(torch.Tensor, name)

        def wrapped(self, *args, _inner=inner, _name=name, **kw):
            if _name == "__setitem__":
                idx = args[0]
            elif _name == "index_put_":
                idx = args[0][0]
            else:
                idx = args[1]
            if isinstance(idx, torch.Tensor) and idx.dtype != torch.bool:
                rows = idx if idx.dim() == 1 else idx[:, 0]
                calls.append((_name, self.shape[0], rows.clone()))
            return _inner(self, *args, **kw)

        monkeypatch.setattr(torch.Tensor, name, wrapped)


def _repeated_real_rows(calls, k) -> list:
    """Calls whose destination rows, outside each partition's dummy row
    (the last of each of the k slices of the destination), repeat."""
    bad = []
    for name, n_rows, rows in calls:
        per = n_rows // k
        real = rows[rows % per != per - 1]
        if real.unique().numel() != real.numel():
            bad.append((name, n_rows, real.numel() - real.unique().numel()))
    return bad


@pytest.mark.parametrize("mode", ["halo", "dense", "ring"])
def test_completion_adds_no_real_row_twice(data, monkeypatch, mode):
    """Every scatter a completion issues on the k=4 book (one
    `edge_aggregate`, sum and max, with fresh random partial aggregates in
    place of `ops.aggregate`'s) adds at most one value to each real row.
    A single `index_add_` of all mirrors into their masters would not: a
    master row receives from several mirrors."""
    tr = _port_trainer(data, "gat", "tiled", mode)
    blk = tr.blocks
    sync = t_sync.make_sync(mode, blk)
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(ops, "aggregate", lambda m, dst, rows, **kw: torch.randn(
        rows, m.shape[1], generator=gen))
    k, n = blk.x.shape[:2]
    payload = torch.randn(k, n, 6, generator=gen)
    calls = []
    _record_scatters(monkeypatch, calls)
    for reduce in ("sum", "max"):
        out = sync.edge_aggregate(blk, payload, lambda s, d, m: s,
                                  reduce=reduce, backend="tiled")
        assert out.shape == (k, n, 6)
    monkeypatch.undo()
    assert _repeated_real_rows(calls, k) == [], calls
    # halo and dense complete partials through scatters; ring sums stages
    assert (len(calls) > 0) == (mode != "ring"), [c[:2] for c in calls]


@pytest.mark.parametrize("mode", ["halo", "dense"])
def test_sum_completions_write_no_pad_slot(data, monkeypatch, mode):
    """The sum completions and halo's broadcast write the real rows only,
    each once (`sync._completion_tables`): no add or assignment reaches a
    dummy row. Under the deterministic algorithms of a training step a
    pile of pad slots on one dummy row is walked serially; leaving them
    out changes no real row (the other tests hold the values)."""
    tr = _port_trainer(data, "sage", "tiled", mode)
    blk = tr.blocks
    sync = t_sync.make_sync(mode, blk)
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(ops, "aggregate", lambda m, dst, rows, **kw: torch.randn(
        rows, m.shape[1], generator=gen))
    k, n = blk.x.shape[:2]
    calls = []
    _record_scatters(monkeypatch, calls)
    sync.edge_aggregate(blk, torch.randn(k, n, 6, generator=gen),
                        lambda s, d, m: s, reduce="sum", backend="tiled")
    monkeypatch.undo()
    assert calls
    real = (int(blk.recv_mask.sum()) + int(blk.send_mask.sum())
            if mode == "halo" else int(blk.vmask.sum()))
    assert sum(rows.numel() for _, _, rows in calls) == real
    for name, n_rows, rows in calls:
        per = n_rows // k
        assert not (rows % per == per - 1).any(), (name, n_rows)
        assert rows.unique().numel() == rows.numel(), (name, n_rows)

"""The port's NumPy host modules are copies of the JAX package's: on the same
inputs they give bit-identical arrays (np.array_equal, no tolerance)."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import cost_model as j_cost  # noqa: E402
from repro.core import edge_partition as j_ep  # noqa: E402
from repro.core import graph as j_graph  # noqa: E402
from repro.core import metrics as j_metrics  # noqa: E402
from repro.core import partition_book as j_book  # noqa: E402
from repro.core import vertex_partition as j_vp  # noqa: E402
from repro.data import tokens as j_tokens  # noqa: E402
from repro.gnn import feature_store as j_fs  # noqa: E402
from repro.gnn import fullbatch as j_fb  # noqa: E402
from repro.gnn.models import GNNSpec as JSpec  # noqa: E402
from repro.kernels import tiling as j_tiling  # noqa: E402
from repro.serve import batcher as j_batcher  # noqa: E402
from repro_torch.core import cost_model as t_cost  # noqa: E402
from repro_torch.core import edge_partition as t_ep  # noqa: E402
from repro_torch.core import graph as t_graph  # noqa: E402
from repro_torch.core import metrics as t_metrics  # noqa: E402
from repro_torch.core import partition_book as t_book  # noqa: E402
from repro_torch.core import vertex_partition as t_vp  # noqa: E402
from repro_torch.data import tokens as t_tokens  # noqa: E402
from repro_torch.gnn import feature_store as t_fs  # noqa: E402
from repro_torch.gnn import fullbatch as t_fb  # noqa: E402
from repro_torch.gnn.models import GNNSpec as TSpec  # noqa: E402
from repro_torch.kernels import tiling as t_tiling  # noqa: E402
from repro_torch.serve import batcher as t_batcher  # noqa: E402

PARTITIONERS = ([("edge", m) for m in sorted(j_ep.EDGE_PARTITIONERS)]
                + [("vertex", m) for m in sorted(j_vp.VERTEX_PARTITIONERS)])


def assert_same(a, b, where="value"):
    """Bitwise equality through dataclasses, tuples, lists and arrays."""
    if dataclasses.is_dataclass(a) or hasattr(a, "_fields"):
        assert type(a).__name__ == type(b).__name__, where
        names = ([f.name for f in dataclasses.fields(a)]
                 if dataclasses.is_dataclass(a) else a._fields)
        for name in names:
            assert_same(getattr(a, name), getattr(b, name), f"{where}.{name}")
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True), where
    else:
        assert a == b or (a != a and b != b), f"{where}: {a!r} != {b!r}"


@pytest.fixture(scope="module")
def graphs():
    return (j_graph.paper_graph("OR", scale=0.02, seed=0),
            t_graph.paper_graph("OR", scale=0.02, seed=0))


def _partition(g, kind, method, ep, vp):
    if kind == "edge":
        return ep.partition_edges(g, 4, method, seed=0)
    return vp.partition_vertices(g, 4, method, seed=0)


@pytest.mark.parametrize("key", ["HO", "DI", "EN", "EU", "OR"])
def test_paper_graph_identical(key):
    jg = j_graph.paper_graph(key, scale=0.01, seed=0)
    tg = t_graph.paper_graph(key, scale=0.01, seed=0)
    assert_same(jg, tg, key)
    assert_same(jg.csr(), tg.csr(), f"{key}.csr")
    assert_same(jg.degrees(), tg.degrees(), f"{key}.degrees")


@pytest.mark.parametrize("kind,method", PARTITIONERS)
def test_partitioners_and_metrics_identical(graphs, kind, method):
    jg, tg = graphs
    ja = _partition(jg, kind, method, j_ep, j_vp)
    ta = _partition(tg, kind, method, t_ep, t_vp)
    assert_same(ja, ta, method)
    if kind == "edge":
        assert_same(j_metrics.edge_partition_metrics(jg, ja, 4),
                    t_metrics.edge_partition_metrics(tg, ta, 4), method)
    else:
        assert_same(j_metrics.vertex_partition_metrics(jg, ja, 4),
                    t_metrics.vertex_partition_metrics(tg, ta, 4), method)


@pytest.mark.parametrize("method", ["hep100", "random", "hdrf"])
@pytest.mark.parametrize("tiled", [True, False])
def test_edge_book_identical(graphs, method, tiled):
    jg, tg = graphs
    a = j_ep.partition_edges(jg, 4, method, seed=0)
    jb = j_book.build_edge_book(jg, a, 4, tiled_layout=tiled)
    tb = t_book.build_edge_book(tg, a, 4, tiled_layout=tiled)
    assert_same(jb, tb, method)
    assert_same(jb.master_assignment(), tb.master_assignment())
    local = np.random.default_rng(0).normal(
        size=tb.vglobal.shape + (3,)).astype(np.float32)
    assert_same(jb.scatter_to_global(local), tb.scatter_to_global(local))


@pytest.mark.parametrize("method", ["metis", "random"])
def test_vertex_book_identical(graphs, method):
    jg, tg = graphs
    owner = j_vp.partition_vertices(jg, 4, method, seed=0)
    assert_same(j_book.build_vertex_book(jg, owner, 4),
                t_book.build_vertex_book(tg, owner, 4), method)


@pytest.mark.parametrize("case", ["plain", "valid_per_tile", "tiling"])
def test_tiled_layout_identical(case):
    rng = np.random.default_rng(4)
    dst = rng.integers(0, 700, 3000).astype(np.int32)
    kw = {}
    if case == "valid_per_tile":
        kw = {"valid": rng.random(3000) < 0.5, "per_tile": 2048}
    elif case == "tiling":
        kw = {"tile_v": 128, "block_e": 256}
    assert_same(j_tiling.prepare_tiled_edges(dst, 700, **kw),
                t_tiling.prepare_tiled_edges(dst, 700, **kw))
    kw.pop("per_tile", None)
    assert_same(j_tiling.tiled_need_per_tile(dst, 700, **kw),
                t_tiling.tiled_need_per_tile(dst, 700, **kw))
    assert (j_tiling.tiled_shape(700, kw.get("tile_v", 256))
            == t_tiling.tiled_shape(700, kw.get("tile_v", 256)))


def test_copied_api_surface_identical():
    """Names the port copies with the reference's API although no port
    path reads them yet: the tile constants and the per-step input-vertex
    balance (paper §5.2)."""
    assert ((t_tiling.DEFAULT_BLOCK_E, t_tiling.DEFAULT_TILE_V,
             t_tiling.DEFAULT_TILE_F)
            == (j_tiling.DEFAULT_BLOCK_E, j_tiling.DEFAULT_TILE_V,
                j_tiling.DEFAULT_TILE_F))
    counts = np.random.default_rng(5).integers(1, 900, 8)
    assert_same(j_metrics.input_vertex_balance(counts),
                t_metrics.input_vertex_balance(counts))


@pytest.mark.parametrize("tiled", [True, False])
@pytest.mark.parametrize("fanouts", [(10,), (5, 5)])
def test_microbatcher_batches_identical(graphs, tiled, fanouts):
    """Same seed, same request stream -> the same padded MFGs, batch after
    batch (the batchers' RNG streams stay in step)."""
    jg, tg = graphs
    owner = j_vp.partition_vertices(jg, 4, "metis", seed=0)
    kw = dict(fanouts=fanouts, max_batch=8, owner=owner, worker=1,
              tiled_layout=tiled, seed=3)
    jb = j_batcher.MicroBatcher.build(jg, **kw)
    tb = t_batcher.MicroBatcher.build(tg, **kw)
    rng = np.random.default_rng(0)
    for _ in range(3):
        ids = rng.integers(0, jg.num_vertices, rng.integers(1, 9))
        assert_same(jb.build_mfg(ids), tb.build_mfg(ids), "mfg")
    arrivals = np.sort(rng.uniform(0, 0.01, 20))
    assert jb.dispatch(arrivals, 0, 0.0) == tb.dispatch(arrivals, 0, 0.0)


@pytest.mark.parametrize("policy", ["none", "random", "degree", "halo"])
def test_cache_selection_and_row_store_identical(graphs, policy):
    jg, tg = graphs
    owner = j_vp.partition_vertices(jg, 4, "metis", seed=0)
    jvb = j_book.build_vertex_book(jg, owner, 4)
    tvb = t_book.build_vertex_book(tg, owner, 4)
    jids = j_fs.select_cache_vertices(jg, jvb, policy, 40, seed=2)
    tids = t_fs.select_cache_vertices(tg, tvb, policy, 40, seed=2)
    assert_same(jids, tids, policy)
    rows = np.random.default_rng(1).normal(
        size=(jg.num_vertices, 6)).astype(np.float32)
    js = j_fs.RowStore.create(jvb, jids, rows=rows, policy=policy, budget=40)
    ts = t_fs.RowStore.create(tvb, tids, rows=rows, policy=policy, budget=40)
    rng = np.random.default_rng(7)
    for w in range(4):
        ids = rng.integers(0, jg.num_vertices, 50)
        (jr, jst), (tr, tst) = js.gather(w, ids), ts.gather(w, ids)
        assert_same(jr, tr, "rows")
        assert tuple(jst) == tuple(tst)
        assert jst.hit_rate == tst.hit_rate


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("hops", [1, 2])
def test_serve_request_identical(model, hops):
    kw = dict(model=model, feature_dim=32, hidden_dim=48, num_classes=7,
              num_layers=3)
    for args in [(200, 80, 0, 1000), (37, 12, 5, 333), (1, 0, 0, 0)]:
        je = j_cost.serve_request(*args, JSpec(**kw), embed_dim=48, hops=hops)
        te = t_cost.serve_request(*args, TSpec(**kw), embed_dim=48, hops=hops)
        assert_same(je, te, model)
    assert_same(j_cost.PAPER_CLUSTER, t_cost.PAPER_CLUSTER)


@pytest.mark.parametrize("model", ["sage", "gat"])
@pytest.mark.parametrize("method", ["hep100", "random"])
def test_fullbatch_accounting_identical(graphs, model, method):
    """The copied `fullbatch_epoch` and the trainers' `comm_bytes_per_epoch`
    / `memory_bytes_per_partition` give the reference's numbers bit for
    bit on the same book (k=4), under each sync mode (ring on the
    block-row book, which ignores the assignment)."""
    jg, tg = graphs
    a = j_ep.partition_edges(jg, 4, method, seed=0)
    kw = dict(model=model, feature_dim=16, hidden_dim=8, num_classes=5,
              num_layers=3)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(jg.num_vertices, 16)).astype(np.float32)
    labels = rng.integers(0, 5, jg.num_vertices).astype(np.int32)
    train = rng.random(jg.num_vertices) < 0.3
    for sync_mode in ("halo", "dense", "ring"):
        jt = j_fb.FullBatchTrainer.build(jg, a, 4, JSpec(**kw), feats,
                                         labels, train, seed=0,
                                         sync_mode=sync_mode)
        tt = t_fb.FullBatchTrainer.build(tg, a, 4, TSpec(**kw), feats,
                                         labels, train, seed=0, device="cpu",
                                         sync_mode=sync_mode)
        assert_same(jt.book, tt.book, f"{sync_mode} book")
        assert_same(j_cost.fullbatch_epoch(jt.book, JSpec(**kw)),
                    t_cost.fullbatch_epoch(tt.book, TSpec(**kw)),
                    f"{sync_mode} estimate")
        assert jt.comm_bytes_per_epoch() == tt.comm_bytes_per_epoch(), (
            sync_mode)
        assert_same(jt.memory_bytes_per_partition(),
                    tt.memory_bytes_per_partition(), f"{sync_mode} memory")


@pytest.mark.parametrize("policy", ["none", "degree", "halo"])
def test_feature_store_build_identical(graphs, policy):
    """`FeatureStore.build` (graph-first, `from_policy` underneath) gives
    the reference's store: caches, rows and accounting, with rows and
    accounting-only."""
    jg, tg = graphs
    owner = j_vp.partition_vertices(jg, 4, "metis", seed=0)
    jvb = j_book.build_vertex_book(jg, owner, 4)
    tvb = t_book.build_vertex_book(tg, owner, 4)
    feats = np.random.default_rng(4).normal(
        size=(jg.num_vertices, 5)).astype(np.float32)
    js = j_fs.FeatureStore.build(jg, jvb, policy=policy, budget=30,
                                 features=feats, seed=1)
    ts = t_fs.FeatureStore.build(tg, tvb, policy=policy, budget=30,
                                 features=feats, seed=1)
    for name in ("policy", "budget", "row_dim", "bytes_per_row", "cache_ids",
                 "cache_sizes", "cache_rows", "rows"):
        assert_same(getattr(js, name), getattr(ts, name), name)
    assert ts.features is ts.rows and ts.feature_dim == js.feature_dim == 5
    ids = np.random.default_rng(2).integers(0, jg.num_vertices, 80)
    for w in range(4):
        (jr, jst), (tr, tst) = js.gather(w, ids), ts.gather(w, ids)
        assert_same(jr, tr, "rows")
        assert tuple(jst) == tuple(tst)
    ja = j_fs.FeatureStore.build(jg, jvb, policy=policy, budget=30,
                                 feature_dim=7)
    ta = t_fs.FeatureStore.build(tg, tvb, policy=policy, budget=30,
                                 feature_dim=7)
    assert tuple(ja.stats(1, ids)) == tuple(ta.stats(1, ids))
    assert ta.features is None


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("cached", [False, True])
def test_minibatch_step_identical(model, cached):
    """`minibatch_step` and `overlapped_step_time` give the reference's
    estimate bit for bit, with and without a feature cache."""
    kw = dict(model=model, feature_dim=64, hidden_dim=32, num_classes=8,
              num_layers=3)
    rng = np.random.default_rng(9)
    inputs = rng.integers(100, 5000, 4)
    remote = inputs // 3
    edges = inputs * 7
    owned = rng.integers(1000, 2000, 4)
    extra = (dict(remote_miss_vertices=remote // 2,
                  cached_vertices=np.full(4, 60)) if cached else {})
    je = j_cost.minibatch_step(inputs, remote, edges, owned, JSpec(**kw),
                               **extra)
    te = t_cost.minibatch_step(inputs, remote, edges, owned, TSpec(**kw),
                               **extra)
    assert_same(je, te, model)
    assert j_cost.overlapped_step_time(je) == t_cost.overlapped_step_time(te)
    # under a lossy codec too (the codecs are ported)
    je8 = j_cost.minibatch_step(inputs, remote, edges, owned, JSpec(**kw),
                                codec="int8", **extra)
    te8 = t_cost.minibatch_step(inputs, remote, edges, owned, TSpec(**kw),
                                codec="int8", **extra)
    assert_same(je8, te8, model)


@pytest.mark.parametrize("seed,vocab,order_states", [
    (0, 256, 512), (3, 151936, 512), (11, 1000, 64)])
def test_synthetic_tokens_identical(seed, vocab, order_states):
    """The LM token corpus: the same transition and emission tables, and
    batch `step` is the same array for a few (seed, step) pairs."""
    kw = dict(vocab_size=vocab, seq_len=24, global_batch=3, seed=seed,
              order_states=order_states)
    jt, tt = j_tokens.SyntheticTokens(**kw), t_tokens.SyntheticTokens(**kw)
    assert jt.n_states == tt.n_states
    assert_same(jt.trans, tt.trans, "trans")
    assert_same(jt.emit_base, tt.emit_base, "emit_base")
    for step in (0, 1, 17):
        jb, tb = jt.batch(step), tt.batch(step)
        assert set(jb) == set(tb) == {"tokens"}
        assert_same(jb["tokens"], tb["tokens"], f"batch {step}")

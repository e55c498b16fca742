"""The port's serving slice against the JAX package's, on the CPU.

  * layer-wise inference embeddings == the JAX engine's, for k in {1, 4}
    (hep100 and random at k=4) x sage/gcn/gat x scatter/tiled, at
    rtol=atol=2e-4 (tests/test_gnn_distributed.py:38's tolerance: the
    halo completion sums in another order than the reference)
  * served logits from build_serving + run_serving_sim == the JAX ones on
    the same trace, and the modeled latency / service time are identical
  * the port's own twin of tests/test_serving.py's full-fanout exactness
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.edge_partition import partition_edges  # noqa: E402
from repro.core.graph import paper_graph as j_paper_graph  # noqa: E402
from repro.core.partition_book import build_vertex_book as j_vbook  # noqa: E402
from repro.gnn import inference as j_inf  # noqa: E402
from repro.gnn import models as jm  # noqa: E402
from repro.serve import build_serving as j_build_serving  # noqa: E402
from repro.serve import run_serving_sim as j_run_sim  # noqa: E402
from repro_torch.core.graph import generate_graph, paper_graph  # noqa: E402
from repro_torch.core.partition_book import build_vertex_book  # noqa: E402
from repro_torch.core.vertex_partition import partition_vertices  # noqa: E402
from repro_torch.gnn import inference as t_inf  # noqa: E402
from repro_torch.gnn import models as tm  # noqa: E402
from repro_torch.serve.engine import build_serving, run_serving_sim  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)
DIMS = dict(feature_dim=12, hidden_dim=8, num_classes=5, num_layers=2)


@pytest.fixture(scope="module")
def setup():
    jg = j_paper_graph("OR", scale=0.02, seed=0)
    tg = paper_graph("OR", scale=0.02, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(tg.num_vertices, DIMS["feature_dim"])).astype(np.float32)
    return jg, tg, feats


def _assignment(g, k, method):
    if k == 1:
        return np.zeros(g.num_edges, np.int64)
    return partition_edges(g, k, method, seed=0)


def _both_params(model, backend, seed=0, **dims):
    dims = {**DIMS, **dims}
    jspec = jm.GNNSpec(model=model, agg_backend=backend, **dims)
    tspec = tm.GNNSpec(model=model, agg_backend=backend, **dims)
    jparams = jm.init_params(jspec, seed=seed)
    tparams = tm.params_from_numpy(jax.tree.map(np.asarray, jparams), CPU)
    return jspec, tspec, jparams, tparams


@pytest.mark.parametrize("backend", ["scatter", "tiled"])
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("k,method", [(1, "none"), (4, "hep100"), (4, "random")])
def test_layerwise_embeddings_match_jax(setup, k, method, model, backend):
    jg, tg, feats = setup
    a = _assignment(jg, k, method)
    jspec, tspec, jparams, tparams = _both_params(model, backend)
    expect = j_inf.LayerwiseInference.build(jg, a, k, jspec, jparams,
                                            feats).run()
    eng = t_inf.LayerwiseInference.build(tg, a, k, tspec, tparams, feats,
                                         device=CPU)
    got = eng.run()
    assert len(got) == len(expect) == DIMS["num_layers"]
    assert len(eng.layer_times) == DIMS["num_layers"]
    for li, (x, y) in enumerate(zip(got, expect)):
        assert x.shape == y.shape and x.dtype == np.float32
        np.testing.assert_allclose(x, y, **TOL, err_msg=f"layer {li}")


def _record_answers(engines):
    """Wrap each JAX engine's `answer` to keep the logits it served."""
    served = []
    for eng in engines:
        def answer(batch, _inner=eng.answer):
            out = _inner(batch)
            served.append(out[0][batch.seed_mask])
            return out
        eng.answer = answer
    return served


@pytest.mark.parametrize("backend", ["scatter", "tiled"])
@pytest.mark.parametrize("model", ["sage", "gat"])
def test_served_logits_and_latency_match_jax(setup, model, backend):
    """Same graph, partition, seed and trace: the same micro-batches are
    served with the same logits (fp32 tolerance), and the modeled latency
    and service times are identical."""
    jg, tg, feats = setup
    k = 4
    a = partition_edges(jg, k, "hep100", seed=0)
    jspec, tspec, jparams, tparams = _both_params(model, backend, seed=2,
                                                  num_layers=3)
    jeng = j_inf.LayerwiseInference.build(jg, a, k, jspec, jparams, feats)
    jemb = jeng.run()
    teng = t_inf.LayerwiseInference.build(tg, a, k, tspec, tparams, feats,
                                          device=CPU)
    temb = teng.run()
    owner = jeng.book.master_assignment()
    np.testing.assert_array_equal(owner, teng.book.master_assignment())
    rng = np.random.default_rng(5)
    req = rng.integers(0, jg.num_vertices, 60)
    arr = np.sort(rng.uniform(0, 60 / 2000.0, 60))
    kw = dict(hops=1, fanout=5, max_batch=8, max_wait=5e-4,
              cache_policy="degree", cache_budget=20, seed=0)
    je, jb, _ = j_build_serving(jg, j_vbook(jg, owner, k), jspec, jparams,
                                jemb, **kw)
    served = _record_answers(je)
    jrep = j_run_sim(je, jb, owner, req, arr)
    te, tb, _ = build_serving(tg, build_vertex_book(tg, owner, k), tspec,
                              tparams, temb, device=CPU, **kw)
    trep = run_serving_sim(te, tb, owner, req, arr)
    assert trep.served() == jrep.served() == 60
    np.testing.assert_array_equal(trep.latency, jrep.latency)
    np.testing.assert_array_equal(trep.service_time, jrep.service_time)
    np.testing.assert_array_equal(trep.latency_worker, jrep.latency_worker)
    np.testing.assert_array_equal(trep.batch_size, jrep.batch_size)
    assert tuple(trep.fetch) == tuple(jrep.fetch)
    np.testing.assert_allclose(trep.logits, np.concatenate(served), **TOL)
    assert trep.logits.shape == (60, DIMS["num_classes"])


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_tiled_and_scatter_serve_the_same_requests(setup, model):
    """Within the port: the backend changes no sampled batch, and the
    served logits agree at fp32 tolerance."""
    _, tg, feats = setup
    owner = partition_vertices(tg, 2, "metis", seed=0)
    a = t_inf.edge_assignment_from_vertex(tg, owner)
    rng = np.random.default_rng(1)
    req = rng.integers(0, tg.num_vertices, 40)
    arr = np.sort(rng.uniform(0, 0.02, 40))
    reports = []
    for backend in ("scatter", "tiled"):
        _, tspec, _, tparams = _both_params(model, backend, num_layers=3)
        emb = t_inf.LayerwiseInference.build(tg, a, 2, tspec, tparams, feats,
                                             device=CPU).run()
        engines, batchers, _ = build_serving(
            tg, build_vertex_book(tg, owner, 2), tspec, tparams, emb,
            device=CPU, hops=1, fanout=5, max_batch=8, seed=0)
        reports.append(run_serving_sim(engines, batchers, owner, req, arr))
    a_rep, b_rep = reports
    np.testing.assert_array_equal(a_rep.served_ids, b_rep.served_ids)
    np.testing.assert_array_equal(a_rep.latency, b_rep.latency)
    np.testing.assert_allclose(a_rep.logits, b_rep.logits, **TOL)


@pytest.mark.parametrize("backend", ["scatter", "tiled"])
@pytest.mark.parametrize("hops", [1, 2])
def test_serve_answer_exact_with_full_fanout(backend, hops):
    """Twin of tests/test_serving.py's test: SAGE + fanout >= max degree,
    so the sampled MFG covers the whole neighborhood and store fetch +
    recompute equals the offline layer-wise logits."""
    g = generate_graph("social", 150, 900, seed=3)
    feats = np.random.default_rng(0).normal(
        size=(g.num_vertices, 12)).astype(np.float32)
    spec = tm.GNNSpec(model="sage", feature_dim=12, hidden_dim=8,
                      num_classes=5, num_layers=3, agg_backend=backend)
    params = tm.init_params(spec, seed=0, device=CPU)
    owner = partition_vertices(g, 2, "metis", seed=0)
    vbook = build_vertex_book(g, owner, 2)
    eng = t_inf.LayerwiseInference.build(
        g, t_inf.edge_assignment_from_vertex(g, owner), 2, spec, params,
        feats, device=CPU)
    embs = eng.run()
    indptr, _ = g.csr()
    full_fanout = int(np.diff(indptr).max())
    engines, batchers, _ = build_serving(
        g, vbook, spec, params, embs, device=CPU, hops=hops,
        fanout=full_fanout, max_batch=6, seed=0)
    rng = np.random.default_rng(3)
    for w in range(2):
        ids = rng.choice(np.where(owner == w)[0], size=6, replace=False)
        mfg = batchers[w].build_mfg(ids)
        logits, stats, host_s = engines[w].answer(mfg)
        np.testing.assert_allclose(logits[:6], embs[-1][ids],
                                   rtol=1e-5, atol=1e-6)
        assert stats.num_input == int(mfg.input_mask.sum())
        assert host_s >= 0.0


def test_serve_hops_validation(setup):
    _, tg, feats = setup
    _, tspec, _, tparams = _both_params("sage", "scatter")
    owner = partition_vertices(tg, 2, "metis", seed=0)
    embs = t_inf.LayerwiseInference.build(
        tg, t_inf.edge_assignment_from_vertex(tg, owner), 2, tspec, tparams,
        feats, device=CPU).run()
    with pytest.raises(ValueError):
        build_serving(tg, build_vertex_book(tg, owner, 2), tspec, tparams,
                      embs, device=CPU, hops=2)  # hops == L


@pytest.mark.parametrize("mode", ["halo", "local"])
def test_sync_bytes_per_round_matches_jax(setup, mode):
    """The port's halo accountant gives the reference's bytes; an unknown
    mode raises, and so does ring on an edge book (its volume needs a
    BlockRowBook, as the reference's)."""
    from repro.core.partition_book import build_edge_book as j_ebook
    from repro.gnn.sync import sync_bytes_per_round as j_bytes
    from repro_torch.core.partition_book import build_edge_book
    from repro_torch.gnn.sync import sync_bytes_per_round

    jg, tg, _ = setup
    a = _assignment(jg, 4, "hep100")
    got = sync_bytes_per_round(build_edge_book(tg, a, 4), 8, mode)
    assert got == j_bytes(j_ebook(jg, a, 4), 8, mode)
    assert (got > 0) == (mode == "halo")
    with pytest.raises(ValueError, match="unknown sync mode"):
        sync_bytes_per_round(build_edge_book(tg, a, 4), 8, "allgather")
    with pytest.raises(TypeError, match="BlockRowBook"):
        sync_bytes_per_round(build_edge_book(tg, a, 4), 8, "ring")

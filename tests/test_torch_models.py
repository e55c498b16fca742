"""The port's GNN parameters and layers against the JAX package's, on the CPU.

init_params draws the same NumPy stream (bit-identical weights); one layer at
k=1 under LocalSync matches the JAX layer for sage/gcn/gat under the scatter
and tiled backends at rtol=atol=1e-5 (fp32; summation order differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core.graph import paper_graph  # noqa: E402
from repro.core.partition_book import build_edge_book  # noqa: E402
from repro.gnn import models as jm  # noqa: E402
from repro.gnn import sync as jsync  # noqa: E402
from repro_torch.gnn import models as tm  # noqa: E402
from repro_torch.gnn import sync as tsync  # noqa: E402

CPU = torch.device("cpu")
SPEC = dict(feature_dim=12, hidden_dim=8, num_classes=5, num_layers=3)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("dims", [(12, 8, 5), (16, 16, 16)])
def test_init_params_bit_identical(model, dims):
    f, h, c = dims
    kw = dict(model=model, feature_dim=f, hidden_dim=h, num_classes=c,
              num_layers=3)
    ref = _np_tree(jm.init_params(jm.GNNSpec(**kw), seed=7))
    port = tm.init_params(tm.GNNSpec(**kw), seed=7, device=CPU)
    assert len(port["layers"]) == len(ref["layers"])
    for pl, rl in zip(port["layers"], ref["layers"]):
        assert pl.keys() == rl.keys()
        for name in rl:
            assert pl[name].dtype == torch.float32
            np.testing.assert_array_equal(pl[name].numpy(), rl[name])


def test_params_from_numpy_round_trips():
    ref = _np_tree(jm.init_params(jm.GNNSpec(model="gat", **SPEC), seed=1))
    port = tm.params_from_numpy(ref, CPU)
    back = {"layers": [{n: t.numpy() for n, t in layer.items()}
                       for layer in port["layers"]]}
    for bl, rl in zip(back["layers"], ref["layers"]):
        for name in rl:
            np.testing.assert_array_equal(bl[name], rl[name])


@pytest.fixture(scope="module")
def k1_setup():
    g = paper_graph("OR", scale=0.02, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(g.num_vertices, SPEC["feature_dim"])).astype(np.float32)
    book = build_edge_book(g, np.zeros(g.num_edges, np.int64), 1,
                           tiled_layout=True)
    zeros = np.zeros(g.num_vertices, np.int32)
    jblk = jax.tree.map(lambda a: a[0],
                        jsync.build_blocks(book, feats, zeros, zeros.astype(bool)))
    tblk = tsync.build_blocks(book, feats, zeros, zeros.astype(bool), device=CPU)
    return g, jblk, tblk


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("backend", ["scatter", "tiled"])
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_layer_k1_matches_jax(k1_setup, model, backend, final):
    g, jblk, tblk = k1_setup
    spec = jm.GNNSpec(model=model, **SPEC)
    params = _np_tree(jm.init_params(spec, seed=3))
    p = params["layers"][0]
    jsy = jsync.make_sync("local", jblk, g.num_vertices, "parts")
    expect = jm._LAYERS[model](jax.tree.map(jax.numpy.asarray, p), jblk.x,
                               jblk, jsy, final=final, backend=backend)
    tp = tm.params_from_numpy(params, CPU)["layers"][0]
    with torch.inference_mode():
        out = tm._LAYERS[model](tp, tblk.x, tblk, tsync.LocalSync(),
                                final=final, backend=backend)
    assert out.shape == (1,) + tuple(expect.shape)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(expect),
                               rtol=1e-5, atol=1e-5)


def test_aggregate_dims_match_reference():
    for model in ("sage", "gcn", "gat"):
        js = jm.GNNSpec(model=model, **SPEC)
        ts = tm.GNNSpec(model=model, **SPEC)
        assert js.dims() == ts.dims()
        assert js.aggregate_dims("halo") == ts.aggregate_dims("halo")

"""The port's wire codecs against the JAX package's, on the CPU.

Same NumPy inputs through both packages, at tests/test_wire.py's sizes (OR
0.01, 8 features, hidden 8, 4 classes, 2 layers, k=4, seed 7):

  (a) codecs and compression: the registry and its errors; fp32 returns
      its input object; bf16 payloads bit for bit `jnp.bfloat16`'s; int8
      payloads and scales bit for bit `Int8EFCodec.encode`'s, on the host
      and stacked (one scale a partition, against `jax.vmap`);
      `wire_bytes` == the encoded bytes (0 for an empty tensor); the
      variable schedule and `narrow_wire_dtypes`; `compress` /
      `decompress`, `compressed_psum` and `codec_grad_reduce` over 3 steps
      of error feedback against the reference under `jax.vmap`
  (b) gradients: each partition's gradient of one k=4 lossy step against
      the reference's per-lane gradients, `jax.vmap(jax.value_and_grad(
      per_device_loss), in_axes=(None, 0), axis_name=AXIS)`, bf16 at 2e-4
      and int8 at 1e-3
  (c) trajectories: 5-step lossy `FullBatchTrainer` and `MiniBatchTrainer`
      runs within 1e-3 a step of the reference trainers with the same
      codec, the EF carry alike
  (d) the fp32 pin: codec "fp32" == codec None bit for bit (losses and
      parameters), full batch (halo, dense, ring) and mini batch
  (e) stores and accounting: lossy feature stores roundtrip only the miss
      rows, bit for bit the reference's, with its `FetchStats`; lossy
      serving logits; the cost model, `sync_wire_bytes_per_round`,
      `collective_budget` and `wire_bytes_per_epoch` bit for bit; the CLIs
      with `--codec` on the CPU
"""

import contextlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cost_model as j_cost  # noqa: E402
from repro.core import wire as j_wire  # noqa: E402
from repro.core.edge_partition import partition_edges  # noqa: E402
from repro.core.graph import paper_graph as j_paper_graph  # noqa: E402
from repro.core.partition_book import build_blockrow_book as j_blockrow  # noqa: E402
from repro.core.partition_book import build_edge_book as j_edge_book  # noqa: E402
from repro.core.partition_book import build_vertex_book as j_vbook  # noqa: E402
from repro.core.vertex_partition import partition_vertices  # noqa: E402
from repro.gnn import feature_store as j_fs  # noqa: E402
from repro.gnn import fullbatch as j_fb  # noqa: E402
from repro.gnn import inference as j_inf  # noqa: E402
from repro.gnn import minibatch as j_mb  # noqa: E402
from repro.gnn import models as jm  # noqa: E402
from repro.gnn import sync as j_sync  # noqa: E402
from repro.optim import compress as j_compress  # noqa: E402
from repro.serve import build_serving as j_build_serving  # noqa: E402
from repro.serve import run_serving_sim as j_run_sim  # noqa: E402
from repro_torch.core import cost_model as t_cost  # noqa: E402
from repro_torch.core import wire as t_wire  # noqa: E402
from repro_torch.core.graph import paper_graph  # noqa: E402
from repro_torch.core.partition_book import build_blockrow_book  # noqa: E402
from repro_torch.core.partition_book import build_edge_book  # noqa: E402
from repro_torch.core.partition_book import build_vertex_book  # noqa: E402
from repro_torch.gnn import feature_store as t_fs  # noqa: E402
from repro_torch.gnn import fullbatch as t_fb  # noqa: E402
from repro_torch.gnn import minibatch as t_mb  # noqa: E402
from repro_torch.gnn import models as tm  # noqa: E402
from repro_torch.gnn import sync as t_sync  # noqa: E402
from repro_torch.launch import gnn_serve, gnn_train  # noqa: E402
from repro_torch.optim import AdamState  # noqa: E402
from repro_torch.optim import compress as t_compress  # noqa: E402
from repro_torch.serve.engine import build_serving, run_serving_sim  # noqa: E402

CPU = torch.device("cpu")
DIMS = dict(feature_dim=8, hidden_dim=8, num_classes=4, num_layers=2)
SEED = 7
K = 4
STEPS = 5
LR = 5e-2               # tests/test_wire.py's trajectory step size
GRAD_TOL = {"bf16": 2e-4, "int8": 1e-3}
TRAJ_TOL = 1e-3
EF_TOL = dict(rtol=1e-6, atol=1e-6)
NAMES = ["fp32", "bf16", "int8"]


def _codec(name):
    """A codec by name; "variable@2" is the variable codec past warmup."""
    if name == "variable@2":
        return "variable@2", t_wire.make_codec("variable").at_epoch(2), \
            j_wire.make_codec("variable").at_epoch(2)
    return name, name, name


def _tree(ref):
    """A JAX {"layers": [...]} tree as NumPy."""
    return jax.tree.map(np.asarray, ref)


def _assert_trees_close(port, ref, what, **tol):
    ref = _tree(ref)
    for li, (pl, rl) in enumerate(zip(port["layers"], ref["layers"])):
        assert pl.keys() == rl.keys()
        for name in rl:
            np.testing.assert_allclose(
                pl[name].detach().numpy(), rl[name],
                err_msg=f"{what}: layer {li} {name}", **tol)


@pytest.fixture(scope="module")
def wg():
    """tests/test_wire.py's graph and node data, in both packages."""
    jg = j_paper_graph("OR", scale=0.01, seed=0)
    tg = paper_graph("OR", scale=0.01, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(tg.num_vertices, 8)).astype(np.float32)
    labels = rng.integers(0, 4, tg.num_vertices).astype(np.int32)
    train = rng.random(tg.num_vertices) < 0.3
    edges = partition_edges(jg, K, "hep100", seed=1)
    verts = partition_vertices(jg, K, "metis", seed=1)
    return jg, tg, feats, labels, train, edges, verts


def _specs(model, backend="tiled"):
    return (jm.GNNSpec(model=model, agg_backend=backend, **DIMS),
            tm.GNNSpec(model=model, agg_backend=backend, **DIMS))


def _fb_pair(wg, model, sync, jcodec, tcodec, **kw):
    """(reference, port) full-batch trainers on the same book and seed."""
    jg, tg, feats, labels, train, edges, _ = wg
    a = None if sync == "ring" else edges
    jspec, tspec = _specs(model)
    ref = j_fb.FullBatchTrainer.build(jg, a, K, jspec, feats, labels, train,
                                      sync_mode=sync, seed=SEED, codec=jcodec,
                                      **kw)
    port = t_fb.FullBatchTrainer.build(tg, a, K, tspec, feats, labels, train,
                                       sync_mode=sync, seed=SEED,
                                       codec=tcodec, device=CPU, **kw)
    return ref, port


def _mb_pair(wg, jcodec, tcodec, model="sage", **kw):
    jg, tg, feats, labels, train, _, verts = wg
    jspec, tspec = _specs(model, "scatter")
    ref = j_mb.MiniBatchTrainer.build(jg, verts, K, jspec, feats, labels,
                                      train, global_batch=32, seed=SEED,
                                      codec=jcodec, **kw)
    port = t_mb.MiniBatchTrainer.build(tg, verts, K, tspec, feats, labels,
                                       train, device=CPU, global_batch=32,
                                       seed=SEED, codec=tcodec, **kw)
    return ref, port


# ------------------------------------------------ (a) codecs and compression
def test_registry_and_errors():
    assert t_wire.CODECS == j_wire.CODECS
    for name in t_wire.CODECS:
        assert t_wire.make_codec(name).name == name
        assert t_wire.make_codec(name).lossless == j_wire.make_codec(
            name).lossless
    assert isinstance(t_wire.as_codec(None), t_wire.Fp32Codec)
    assert t_wire.as_codec("int8") is t_wire.make_codec("int8")
    c = t_wire.make_codec("bf16")
    assert t_wire.as_codec(c) is c
    assert isinstance(c, t_wire.Codec)
    with pytest.raises(ValueError, match="unknown codec"):
        t_wire.make_codec("fp8")
    with pytest.raises(ValueError, match="stacked"):
        t_wire.make_codec("int8").encode(np.ones((2, 3), np.float32),
                                         stacked=True)


@pytest.mark.parametrize("host", [True, False])
def test_fp32_returns_its_input(host):
    x = np.random.default_rng(1).normal(size=(7, 5)).astype(np.float32)
    if not host:
        x = torch.tensor(x)
    c = t_wire.make_codec("fp32")
    for stacked in (False, True):
        payload, meta = c.encode(x, stacked=stacked)
        assert payload is x and meta is None
        assert c.decode(payload, meta) is x
    assert c.ratio(0) == c.ratio(3) == 1.0


@pytest.mark.parametrize("host", [True, False])
def test_bf16_payload_bit_equal_to_jnp(host):
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(64, 9)) * 10.0 ** rng.integers(-6, 6, (64, 9))
         ).astype(np.float32)
    want = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    c = t_wire.make_codec("bf16")
    payload, meta = c.encode(x if host else torch.tensor(x))
    assert meta is None
    if host:
        assert payload.dtype == t_wire.HOST_BF16
        got = payload
    else:
        assert payload.dtype == torch.bfloat16
        got = payload.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    back = c.decode(payload, meta)
    back = back if host else back.numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jnp.asarray(x).astype(jnp.bfloat16), np.float32))


@pytest.mark.parametrize("form", ["host", "tensor", "stacked"])
def test_int8_payload_and_scale_bit_equal(form):
    x = np.random.default_rng(3).normal(size=(4, 4, 30, 8)).astype(
        np.float32)
    ref = j_wire.Int8EFCodec()
    c = t_wire.make_codec("int8")
    if form == "stacked":
        want_q, want_s = jax.vmap(ref.encode)(jnp.asarray(x))
        q, s = c.encode(torch.tensor(x), stacked=True)
        assert s.shape == (4,)
    elif form == "tensor":
        want_q, want_s = ref.encode(jnp.asarray(x))
        q, s = c.encode(torch.tensor(x))
        assert s.shape == ()
    else:
        want_q, want_s = ref.encode(x)
        q, s = c.encode(x)
        assert isinstance(q, np.ndarray) and s.dtype == np.float32
    q, s = np.asarray(q), np.asarray(s)
    assert q.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(q, np.asarray(want_q))
    np.testing.assert_array_equal(s, np.asarray(want_s))
    np.testing.assert_array_equal(
        np.asarray(c.decode(*c.encode(x if form == "host"
                                      else torch.tensor(x),
                                      stacked=form == "stacked"))),
        np.asarray(jax.vmap(lambda v: ref.decode(*ref.encode(v)))(
            jnp.asarray(x)) if form == "stacked"
            else ref.decode(want_q, want_s)))


@pytest.mark.parametrize("host", [True, False])
@pytest.mark.parametrize("shape", [(5,), (3, 4), (2, 3, 5), (128, 16)])
@pytest.mark.parametrize("name", NAMES)
def test_wire_bytes_equal_encoded_bytes(name, shape, host):
    c = t_wire.make_codec(name)
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    payload, meta = c.encode(x if host else torch.tensor(x))
    measured = (payload.nbytes if host else payload.numel()
                * payload.element_size())
    if meta is not None:
        measured += np.asarray(meta).nbytes
    assert c.wire_bytes(shape) == measured
    assert c.wire_bytes(shape) == j_wire.make_codec(name).wire_bytes(shape)


@pytest.mark.parametrize("name", NAMES)
def test_wire_bytes_empty_tensor_is_zero(name):
    c = t_wire.make_codec(name)
    assert c.wire_bytes((0, 16)) == 0
    payload, _ = c.encode(torch.zeros(3, 0, 4), stacked=True)
    assert payload.numel() == 0


def test_variable_schedule_and_narrow_dtypes():
    t, j = t_wire.make_codec("variable"), j_wire.make_codec("variable")
    assert isinstance(t, t_wire.VariableRatioCodec)
    for epoch in range(4):
        te, je = t.at_epoch(epoch), j.at_epoch(epoch)
        assert t.epoch == 0 and te.epoch == epoch
        for layer in range(4):
            assert te.ratio(layer) == je.ratio(layer)
            for shape in ((10, 4), (0, 4), (3, 5, 7)):
                assert (te.wire_bytes(shape, layer=layer)
                        == je.wire_bytes(shape, layer=layer))
            x = np.random.default_rng(layer).normal(size=(6, 3)).astype(
                np.float32)
            for inp in (x, torch.tensor(x)):
                np.testing.assert_array_equal(
                    np.asarray(t_wire.roundtrip(te, inp, layer=layer)),
                    np.asarray(j_wire.roundtrip(je, jnp.asarray(x),
                                                layer=layer)))
        assert (t_wire.narrow_wire_dtypes(te)
                == j_wire.narrow_wire_dtypes(je))
    for name in t_wire.CODECS:
        assert (t_wire.narrow_wire_dtypes(name)
                == j_wire.narrow_wire_dtypes(name))


def _lane_grads(rng, steps):
    return [{"w": rng.normal(size=(K, 6, 5)).astype(np.float32),
             "b": rng.normal(size=(K, 5)).astype(np.float32)}
            for _ in range(steps)]


def _port_tree(d):
    return {"layers": [{n: torch.tensor(a) for n, a in d.items()}]}


def test_compress_decompress_over_ef_steps():
    """`compress` (stacked, one scale a partition), `decompress` and
    `compressed_psum` against the reference's under `jax.vmap`, 3 steps
    of error feedback."""
    seq = _lane_grads(np.random.default_rng(11), 3)
    j_state = jax.vmap(j_compress.compress_init)(seq[0])
    t_state = t_compress.compress_init(_port_tree(seq[0]))
    j_psum = jax.vmap(lambda g, s: j_compress.compressed_psum(g, s, "parts"),
                      axis_name="parts")
    p_state = t_state
    jp_state = j_state
    for g in seq:
        jq, js, j_state = jax.vmap(j_compress.compress)(g, j_state)
        tq, ts, t_state = t_compress.compress(_port_tree(g), t_state,
                                              stacked=True)
        jd = jax.vmap(j_compress.decompress)(jq, js)
        td = t_compress.decompress(tq, ts)
        for n in g:
            np.testing.assert_array_equal(tq["layers"][0][n].numpy(),
                                          np.asarray(jq[n]))
            np.testing.assert_array_equal(ts["layers"][0][n].numpy(),
                                          np.asarray(js[n]))
            np.testing.assert_array_equal(td["layers"][0][n].numpy(),
                                          np.asarray(jd[n]))
            np.testing.assert_allclose(t_state.error["layers"][0][n].numpy(),
                                       np.asarray(j_state.error[n]),
                                       **EF_TOL)
        jm_, jp_state = j_psum(g, jp_state)
        tm_, p_state = t_compress.compressed_psum(_port_tree(g), p_state)
        for n in g:
            np.testing.assert_allclose(tm_["layers"][0][n].numpy(),
                                       np.asarray(jm_[n])[0], **EF_TOL)
            np.testing.assert_allclose(p_state.error["layers"][0][n].numpy(),
                                       np.asarray(jp_state.error[n]),
                                       **EF_TOL)


@pytest.mark.parametrize("name", ["fp32", "bf16", "int8", "variable@2"])
def test_codec_grad_reduce_over_ef_steps(name):
    """The error-feedback mean over 3 steps against the reference under
    `jax.vmap` (lane 0 of its replica-consistent pmean)."""
    _, tcodec, jcodec = _codec(name)
    tcodec, jcodec = t_wire.as_codec(tcodec), j_wire.as_codec(jcodec)
    seq = _lane_grads(np.random.default_rng(12), 3)
    fn = jax.vmap(lambda g, e: j_wire.codec_grad_reduce(jcodec, g, e,
                                                        "parts"),
                  axis_name="parts")
    j_ef = j_wire.ef_init(seq[0])
    t_ef = t_wire.ef_init(_port_tree(seq[0]))
    for g in seq:
        j_mean, j_ef = fn(g, j_ef)
        t_mean, t_ef = t_wire.codec_grad_reduce(tcodec, _port_tree(g), t_ef,
                                                stacked=True)
        for n in g:
            assert t_mean["layers"][0][n].shape == g[n].shape[1:]
            np.testing.assert_allclose(t_mean["layers"][0][n].numpy(),
                                       np.asarray(j_mean[n])[0], **EF_TOL)
            np.testing.assert_allclose(t_ef["layers"][0][n].numpy(),
                                       np.asarray(j_ef[n]), **EF_TOL)
    if tcodec.lossless:
        assert all(not t.any() for t in t_ef["layers"][0].values())
    # k == 1: no reduce, the quantisation and EF still apply
    one = {n: a[0] for n, a in seq[0].items()}
    j_mean, j_ef = j_wire.codec_grad_reduce(jcodec, one,
                                            j_wire.ef_init(one), None)
    t_mean, t_ef = t_wire.codec_grad_reduce(
        tcodec, _port_tree(one), t_wire.ef_init(_port_tree(one)),
        stacked=False)
    for n in one:
        np.testing.assert_allclose(t_mean["layers"][0][n].numpy(),
                                   np.asarray(j_mean[n]), **EF_TOL)
        np.testing.assert_allclose(t_ef["layers"][0][n].numpy(),
                                   np.asarray(j_ef[n]), **EF_TOL)


def test_ef_from_numpy_carries_the_reference_tree():
    ef = {"layers": [{"w": np.ones((K, 3, 2), np.float32),
                      "b": np.zeros((K, 2), np.float32)}]}
    got = t_wire.ef_from_numpy(jax.tree.map(jnp.asarray, ef), CPU)
    assert got["layers"][0]["w"].dtype == torch.float32
    assert got["layers"][0]["w"].shape == (K, 3, 2)
    assert torch.equal(got["layers"][0]["w"], torch.ones(K, 3, 2))


# --------------------------------------------------------------- (b) grads
GRAD_CASES = ([(m, s, c) for m in ("sage", "gcn", "gat")
               for s in ("halo", "ring") for c in ("bf16", "int8")]
              + [(m, "dense", c) for m in ("sage", "gcn")
                 for c in ("bf16", "int8")])


def _count_far(got, want, tol):
    return int((np.abs(got - want) > tol + tol * np.abs(want)).sum())


@pytest.mark.parametrize("model,sync,codec", GRAD_CASES)
def test_per_partition_grads_match_reference(wg, model, sync, codec):
    """Partition j's gradient k * dL/dW_j == the reference's lane-j
    gradient (the gradient of the k lanes' summed losses w.r.t. lane j's
    copy of the parameters)."""
    ref, port = _fb_pair(wg, model, sync, codec, codec)
    loss, _ = j_fb.make_step_fns(ref.spec, sync, ref.book.num_vertices, K,
                                 codec=codec)
    j_loss, j_grads = jax.jit(jax.vmap(
        jax.value_and_grad(loss), in_axes=(None, 0),
        axis_name=j_fb.AXIS))(ref.params, ref.blocks)
    loss_of, _ = port._step_fns
    t_loss, t_grads = tm.per_partition_grads(
        lambda p: loss_of(p, port.blocks), port.params, k=K, stacked=True)
    np.testing.assert_allclose(float(t_loss), np.asarray(j_loss),
                               rtol=1e-5, atol=1e-5)
    tol = GRAD_TOL[codec]
    j_grads = _tree(j_grads)
    far = {}
    for li, (pl, rl) in enumerate(zip(t_grads["layers"], j_grads["layers"])):
        for name in rl:
            got = pl[name].numpy()
            assert got.shape == rl[name].shape == (K,) + tuple(
                port.params["layers"][li][name].shape)
            n = _count_far(got, rl[name], tol)
            if n:
                far[f"layer {li} {name}"] = (n, float(np.abs(
                    got - rl[name]).max()))
    assert not far, f"{codec}: elements beyond {tol} (count, max): {far}"


# -------------------------------------------------------- (c) trajectories
TRAJ_CASES = [("sage", "halo", "int8"), ("sage", "ring", "int8"),
              ("gcn", "halo", "int8"), ("gcn", "ring", "int8"),
              ("gat", "halo", "int8"), ("gat", "ring", "variable@2"),
              ("sage", "dense", "int8")]


@pytest.fixture(scope="module")
def trajectories(wg):
    """Per TRAJ_CASES case, built once: the reference and port trainers
    (lr 5e-2) and their STEPS-step loss trajectories from the same start;
    the step-by-step EF test continues from the trainers' states."""
    cache = {}

    def get(model, sync, codec):
        if (model, sync, codec) not in cache:
            _, tcodec, jcodec = _codec(codec)
            ref, port = _fb_pair(wg, model, sync, jcodec, tcodec, lr=LR)
            cache[model, sync, codec] = (
                ref, port, [ref.train_step() for _ in range(STEPS)],
                [port.train_step() for _ in range(STEPS)])
        return cache[model, sync, codec]

    return get


@pytest.mark.parametrize("model,sync,codec", TRAJ_CASES)
def test_lossy_trajectory_fullbatch_matches_reference(trajectories, model,
                                                      sync, codec):
    _, _, j_losses, t_losses = trajectories(model, sync, codec)
    dev = max(abs(a - b) for a, b in zip(j_losses, t_losses))
    assert dev < TRAJ_TOL, (dev, j_losses, t_losses)
    assert t_losses[-1] < t_losses[0]


def _carry(port, ref):
    """The reference trainer's parameters, Adam state and EF carry into
    the port's trainer."""
    port.params = tm.params_from_numpy(_tree(ref.params), CPU)
    port.opt_state = AdamState(
        step=torch.tensor(int(ref.opt_state.step), dtype=torch.int32),
        mu=tm.params_from_numpy(_tree(ref.opt_state.mu), CPU),
        nu=tm.params_from_numpy(_tree(ref.opt_state.nu), CPU))
    port.ef_state = (port._init_ef() if ref.ef_state is None
                     else t_wire.ef_from_numpy(_tree(ref.ef_state), CPU))


@pytest.mark.parametrize("model,sync,codec", TRAJ_CASES)
def test_ef_carry_matches_reference_step_by_step(trajectories, model, sync,
                                                 codec):
    """Each step started from the reference's state (parameters, Adam
    state, EF carry): the port's loss and new EF carry against the
    reference's after the same step, continuing the trajectories'
    trainers. Where bf16 crosses the wire (`variable`) the reference's
    step runs op by op (`jax.disable_jit`): compiled, XLA keeps bf16
    cotangents at f32 precision across its fusions, which moves the
    gradient at the bf16 level, while the port rounds each cotangent as
    the reference's program says. The EF carry is within 1e-5 of the
    reference's, except where a
    corrected gradient sat on an int8 rounding boundary and the packages'
    last bits chose different levels: such an element is at most one
    level of its partition's scale (max|g + e| / 127) further off. Those
    flips are counted and must stay rare (at most 1% of the carry a
    step)."""
    tol = 1e-5
    ref, port, _, _ = trajectories(model, sync, codec)
    loss_of, _ = port._step_fns
    # op by op the reference takes ~13 s a GAT ring step here: one step
    eager, steps = ((jax.disable_jit, 1) if codec == "variable@2"
                    else (contextlib.nullcontext, 3))
    flips = []
    for step in range(steps):
        _carry(port, ref)
        prev = port.ef_state
        _, grads = tm.per_partition_grads(
            lambda p: loss_of(p, port.blocks), port.params, k=K,
            stacked=True)
        with eager():
            j_loss = ref.train_step()
        t_loss = port.train_step()
        assert abs(j_loss - t_loss) < 1e-5, (step, j_loss, t_loss)
        want = _tree(ref.ef_state)
        n_flip = n_all = 0
        for li, layer in enumerate(want["layers"]):
            for name, w in layer.items():
                got = port.ef_state["layers"][li][name].numpy()
                corrected = (grads["layers"][li][name]
                             + prev["layers"][li][name]).reshape(K, -1)
                level = (corrected.abs().amax(1) / 127.0).numpy().reshape(
                    (K,) + (1,) * (w.ndim - 1))
                diff = np.abs(got - w)
                flip = diff > tol
                assert np.all(diff <= tol + level), (
                    f"step {step} layer {li} {name}: EF off by more than "
                    f"one int8 level: {diff[flip]} vs levels "
                    f"{np.broadcast_to(level, w.shape)[flip]}")
                n_flip += int(flip.sum())
                n_all += w.size
        flips.append(n_flip)
        assert n_flip <= 0.01 * n_all, (step, flips, n_all)
    print(f"{model} {sync} {codec}: EF elements one int8 level apart a "
          f"step: {flips} of {n_all}")


def test_lossy_trajectory_minibatch_matches_reference(wg):
    ref, port = _mb_pair(wg, "int8", "int8", lr=LR)
    try:
        for step in range(STEPS):
            mr, mp = ref.train_step(), port.train_step()
            assert abs(mr.loss - mp.loss) < TRAJ_TOL, (step, mr.loss, mp.loss)
            np.testing.assert_array_equal(mp.miss_bytes, mr.miss_bytes)
            np.testing.assert_array_equal(mp.wire_bytes, mr.wire_bytes)
            assert (mp.wire_bytes < 0.3 * mp.miss_bytes).all()
        assert port.ef_state["layers"][0]["w_self"].shape[0] == K
        _assert_trees_close(port.ef_state, ref.ef_state, "EF carry",
                            rtol=TRAJ_TOL, atol=TRAJ_TOL)
    finally:
        ref.close()
        port.close()


# ------------------------------------------------------------ (d) fp32 pin
def _params_equal(a, b):
    return all(torch.equal(x, y) for la, lb in zip(a["layers"], b["layers"])
               for x, y in zip(la.values(), lb.values()))


@pytest.mark.parametrize("sync", ["halo", "dense", "ring"])
def test_fp32_codec_bitwise_identical_fullbatch(wg, sync):
    """Under deterministic algorithms: on the CPU the gathers' backward
    adds in thread order otherwise, and no two runs would agree."""
    _, tg, feats, labels, train, edges, _ = wg
    a = None if sync == "ring" else edges
    _, tspec = _specs("gat" if sync != "dense" else "sage")
    trainers = [t_fb.FullBatchTrainer.build(
        tg, a, K, tspec, feats, labels, train, sync_mode=sync, seed=SEED,
        codec=codec, device=CPU) for codec in (None, "fp32")]
    for _ in range(3):
        with t_mb.repeatable_step():
            losses = [tr.train_step() for tr in trainers]
        assert losses[0] == losses[1], losses
    assert _params_equal(trainers[0].params, trainers[1].params)
    assert trainers[1].ef_state is None


def test_fp32_codec_bitwise_identical_minibatch(wg):
    _, tg, feats, labels, train, _, verts = wg
    _, tspec = _specs("gat", "tiled")
    trainers = [t_mb.MiniBatchTrainer.build(
        tg, verts, K, tspec, feats, labels, train, device=CPU,
        global_batch=32, seed=SEED, codec=codec) for codec in (None, "fp32")]
    try:
        for _ in range(3):
            m0, m1 = (tr.train_step() for tr in trainers)
            assert m0.loss == m1.loss
            np.testing.assert_array_equal(m1.wire_bytes, m1.miss_bytes)
    finally:
        for tr in trainers:
            tr.close()
    assert _params_equal(trainers[0].params, trainers[1].params)


# ----------------------------------------------- (e) stores and accounting
@pytest.mark.parametrize("codec", ["fp32", "bf16", "int8", "variable"])
def test_feature_store_matches_reference(wg, codec):
    """A lossy store roundtrips exactly the miss rows (local and cache-hit
    rows stay bit for bit), with the reference's bytes and stats; its
    `wire_bytes` is the measured payload + meta."""
    jg, tg, feats, _, _, _, verts = wg
    jb, tb = j_vbook(jg, verts, K), build_vertex_book(tg, verts, K)
    ids = np.random.default_rng(10).integers(0, tg.num_vertices, 200)
    ref = j_fs.FeatureStore.build(jg, jb, policy="degree", budget=16,
                                  features=feats, codec=codec)
    port = t_fs.FeatureStore.build(tg, tb, policy="degree", budget=16,
                                   features=feats, codec=codec)
    for w in range(K):
        (rb, rs), (pb, ps) = ref.gather(w, ids), port.gather(w, ids)
        np.testing.assert_array_equal(pb, rb)
        assert tuple(ps) == tuple(rs)
        assert tuple(port.stats(w, ids)) == tuple(ps)
        local, hit, miss = port.split(w, ids)
        assert miss.sum() > 0
        np.testing.assert_array_equal(pb[local | hit], feats[ids[local | hit]])
        err = np.abs(pb[miss] - feats[ids[miss]]).max()
        assert (err == 0.0) == (codec == "fp32")


@pytest.mark.parametrize("codec", ["bf16", "int8"])
def test_lossy_serving_logits_match_reference(wg, codec):
    """The same embeddings served through a lossy store: the same logits
    (2e-4) and modeled latencies, priced with the store's codec."""
    jg, tg, feats, _, _, edges, _ = wg
    jspec, tspec = (s.__class__(**{**s.__dict__, "num_layers": 3})
                    for s in _specs("gat"))
    jparams = jm.init_params(jspec, seed=2)
    tparams = tm.params_from_numpy(_tree(jparams), CPU)
    jeng = j_inf.LayerwiseInference.build(jg, edges, K, jspec, jparams, feats)
    emb = jeng.run()
    owner = jeng.book.master_assignment()
    rng = np.random.default_rng(5)
    req = rng.integers(0, jg.num_vertices, 60)
    arr = np.sort(rng.uniform(0, 60 / 2000.0, 60))
    kw = dict(hops=1, fanout=5, max_batch=8, max_wait=5e-4, seed=0,
              codec=codec)
    je, jb, jstore = j_build_serving(jg, j_vbook(jg, owner, K), jspec,
                                     jparams, emb, **kw)
    served = []
    for eng in je:
        def answer(batch, _inner=eng.answer):
            out = _inner(batch)
            served.append(out[0][batch.seed_mask])
            return out
        eng.answer = answer
    jrep = j_run_sim(je, jb, owner, req, arr)
    te, tb, tstore = build_serving(tg, build_vertex_book(tg, owner, K), tspec,
                                   tparams, emb, device=CPU, **kw)
    trep = run_serving_sim(te, tb, owner, req, arr)
    assert tstore.codec.name == codec
    assert tuple(trep.fetch) == tuple(jrep.fetch)
    assert trep.fetch.wire_bytes < trep.fetch.miss_bytes
    np.testing.assert_array_equal(trep.service_time, jrep.service_time)
    np.testing.assert_array_equal(trep.latency, jrep.latency)
    np.testing.assert_allclose(trep.logits, np.concatenate(served),
                               rtol=2e-4, atol=2e-4)


ACCOUNT_CODECS = ["fp32", "bf16", "int8", "variable", "variable@2"]


@pytest.fixture(scope="module")
def books(wg):
    jg, tg, _, _, _, edges, _ = wg
    return {"edge": (j_edge_book(jg, edges, K), build_edge_book(tg, edges, K)),
            "ring": (j_blockrow(jg, K), build_blockrow_book(tg, K))}


@pytest.mark.parametrize("codec", ACCOUNT_CODECS)
@pytest.mark.parametrize("book", ["edge", "ring"])
def test_sync_wire_bytes_and_collective_budget(books, book, codec):
    _, tcodec, jcodec = _codec(codec)
    jb, tb = books[book]
    modes = ["ring"] if book == "ring" else ["halo", "dense", "local"]
    for mode in modes:
        for d in (1, 4, 8, 12):
            for layer in range(4):
                assert (t_sync.sync_wire_bytes_per_round(
                    tb, d, mode, tcodec, layer=layer)
                    == j_sync.sync_wire_bytes_per_round(
                        jb, d, mode, jcodec, layer=layer)), (mode, d, layer)
                if mode != "local":
                    assert (t_cost.collective_budget(tb, d, mode, tcodec,
                                                     layer)
                            == j_cost.collective_budget(jb, d, mode, jcodec,
                                                        layer))
    if codec == "fp32":
        for mode in modes:
            assert (t_sync.sync_wire_bytes_per_round(tb, 8, mode)
                    == t_sync.sync_bytes_per_round(tb, 8, mode))


def _same_estimate(a, b):
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


@pytest.mark.parametrize("codec", ACCOUNT_CODECS)
@pytest.mark.parametrize("model", ["sage", "gat"])
def test_cost_model_matches_reference(books, model, codec):
    _, tcodec, jcodec = _codec(codec)
    jspec, tspec = _specs(model)
    for jb, tb in books.values():
        _same_estimate(t_cost.fullbatch_epoch(tb, tspec, codec=tcodec),
                       j_cost.fullbatch_epoch(jb, jspec, codec=jcodec))
    args = (np.array([900.0, 700.0]), np.array([400.0, 100.0]),
            np.array([4000.0, 3000.0]), np.array([250.0, 260.0]))
    _same_estimate(t_cost.minibatch_step(*args, tspec, codec=tcodec),
                   j_cost.minibatch_step(*args, jspec, codec=jcodec))
    _same_estimate(
        t_cost.serve_request(64, 40, 25, 300, tspec, embed_dim=8, hops=1,
                             codec=tcodec),
        j_cost.serve_request(64, 40, 25, 300, jspec, embed_dim=8, hops=1,
                             codec=jcodec))


@pytest.mark.parametrize("codec", ACCOUNT_CODECS)
@pytest.mark.parametrize("model,sync", [("gat", "halo"), ("gat", "ring"),
                                        ("sage", "dense")])
def test_wire_bytes_per_epoch_matches_reference(wg, model, sync, codec):
    _, tcodec, jcodec = _codec(codec)
    ref, port = _fb_pair(wg, model, sync, jcodec, tcodec)
    assert port.wire_bytes_per_epoch() == ref.wire_bytes_per_epoch()
    assert port.comm_bytes_per_epoch() == ref.comm_bytes_per_epoch()
    if codec == "fp32":
        assert port.wire_bytes_per_epoch() == port.comm_bytes_per_epoch()


def test_set_epoch_advances_the_variable_codec(wg):
    ref, port = _fb_pair(wg, "gat", "halo", "variable", "variable")
    for epoch in range(4):
        ref.set_epoch(epoch)
        port.set_epoch(epoch)
        assert port.codec.epoch == ref.codec.epoch == epoch
        assert port.wire_bytes_per_epoch() == ref.wire_bytes_per_epoch()
    _, mb = _mb_pair(wg, None, "variable")
    mb.set_epoch(3)
    assert mb.codec.epoch == 3 and mb.store.codec.epoch == 0
    mb.close()


# ------------------------------------------------------------------ CLIs
TINY = ["--device", "cpu", "--graph", "OR", "--scale", "0.01", "--k", "4",
        "--features", "8", "--hidden", "8", "--classes", "4", "--layers", "2"]


@pytest.mark.parametrize("regime", ["fullbatch", "minibatch"])
def test_cli_trains_with_int8(capsys, regime):
    extra = (["--regime", "minibatch", "--partitioner", "metis", "--batch",
              "32", "--epochs", "2"] if regime == "minibatch"
             else ["--epochs", "3", "--model", "gat", "--agg-backend",
                   "tiled"])
    run = gnn_train.run(TINY + extra + ["--codec", "int8"])
    assert all(np.isfinite(run.losses)) and len(run.losses) >= 2
    assert run.trainer.ef_state is not None
    assert np.all(run.estimate.wire_bytes <= 0.25 * (
        run.estimate.comm_bytes if regime == "fullbatch"
        else run.estimate.fetch_bytes))
    out = capsys.readouterr().out
    assert "int8" in out and ("wire/step" in out or "wire " in out)


def test_cli_serves_with_bf16(capsys, tmp_path):
    path = tmp_path / "row.json"
    run = gnn_serve.run(TINY + ["--model", "gat", "--agg-backend", "tiled",
                                "--smoke", "--codec", "bf16",
                                "--out-json", str(path)])
    assert run.report.fetch.wire_bytes * 2 == run.report.fetch.miss_bytes
    assert np.isfinite(run.report.logits).all()
    assert "(bf16)" in capsys.readouterr().out
    # the study row carries the codec and both byte columns
    [row] = json.loads(path.read_text())
    assert row["codec"] == "bf16"
    assert row["wire_bytes"] * 2 == row["miss_bytes"] > 0

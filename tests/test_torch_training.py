"""The port's full-batch training slice against the JAX package's, on the CPU.

Same numpy inputs through both packages (the JAX tiled backend runs its jnp
oracle off-TPU, with its `custom_vjp`s; the full-batch cases hold both of
the port's backends to the reference's tiled trainer):

  (a) `optim.adam_update` == `repro.optim.adam_update`, 5 steps, rtol 1e-6
  (b) `ops.aggregate` gradients, sum and max, scatter and tiled, ties and a
      dropped tied edge included, rtol=atol=1e-5 (tests/test_aggregate.py)
  (c) `loss_fn` gradients at k=4 under halo sync == the reference's vmap
      gradients, sage/gcn/gat x scatter/tiled, rtol=atol=2e-4 (GAT's
      softmax shift must carry no gradient, as the reference's
      stop_gradient)
  (d) the MFG GAT layer's gradients == the reference's `_mb_gat_layer`
  (e) distributed (k=4 halo) == the k=1 LocalSync oracle within the port:
      forward logits and a 3-step loss trajectory
  (f) a 5-step `FullBatchTrainer` loss trajectory == the reference
      trainer's on the same assignment and seed, |dloss| < 1e-4 a step,
      final parameters at rtol=atol=2e-4
  (g) the `gnn_train` CLI trains on the CPU with falling losses, and
      raises at once without `--device cpu` when no GPU is visible
  (h) the checkpoint and fault flags run (tests/test_torch_fault.py holds
      what they do); the reference's unported flags are refused
      (`--regime minibatch` is tests/test_torch_minibatch.py's,
      `--sync-mode dense|ring` tests/test_torch_sync.py's)
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.edge_partition import partition_edges  # noqa: E402
from repro.core.graph import paper_graph as j_paper_graph  # noqa: E402
from repro.gnn import fullbatch as j_fb  # noqa: E402
from repro.gnn import minibatch as j_mb  # noqa: E402
from repro.gnn import models as jm  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.optim import adam_init as j_adam_init  # noqa: E402
from repro.optim import adam_update as j_adam_update  # noqa: E402
from repro_torch.core.graph import paper_graph  # noqa: E402
from repro_torch.fault import WorkerCrash  # noqa: E402
from repro_torch.gnn import fullbatch as t_fb  # noqa: E402
from repro_torch.gnn import minibatch as t_mb  # noqa: E402
from repro_torch.gnn import models as tm  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.tiling import prepare_tiled_edges  # noqa: E402
from repro_torch.launch import gnn_serve, gnn_train  # noqa: E402
from repro_torch.obs import load_trace  # noqa: E402
from repro_torch.optim import adam_init, adam_update  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_gnn_distributed.py:38
DIMS = dict(feature_dim=16, hidden_dim=8, num_classes=5, num_layers=3)
SEED = 7
STEPS = 5
MODELS = ["sage", "gcn", "gat"]
BACKENDS = ["scatter", "tiled"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_np(tree):
    return {"layers": [{n: t.detach().numpy() for n, t in layer.items()}
                       for layer in tree["layers"]]}


def _assert_trees_close(port, ref, **tol):
    assert len(port["layers"]) == len(ref["layers"])
    for li, (pl, rl) in enumerate(zip(port["layers"], ref["layers"])):
        assert pl.keys() == rl.keys()
        for name in rl:
            np.testing.assert_allclose(pl[name], rl[name],
                                       err_msg=f"layer {li} {name}", **tol)


# ------------------------------------------------------------------ (a) Adam
def test_adam_update_matches_reference():
    rng = np.random.default_rng(0)
    shapes = [{"w": (6, 4), "b": (4,)}, {"w": (4, 3), "a": (2, 2)}]
    init = {"layers": [{n: rng.normal(size=s).astype(np.float32)
                        for n, s in layer.items()} for layer in shapes]}
    jp = jax.tree.map(jnp.asarray, init)
    tp = tm.params_from_numpy(init, CPU)
    js, ts = j_adam_init(jp), adam_init(tp)
    for step in range(STEPS):
        g = {"layers": [{n: (rng.normal(size=s) * 10.0 ** (step - 2))
                         .astype(np.float32) for n, s in layer.items()}
                        for layer in shapes]}
        before = _port_np(tp)
        jp, js = j_adam_update(jax.tree.map(jnp.asarray, g), js, jp, lr=1e-2)
        tp_new, ts = adam_update(tm.params_from_numpy(g, CPU), ts, tp,
                                 lr=1e-2)
        # pure: the old parameters are left as they were
        _assert_trees_close(_port_np(tp), before, rtol=0, atol=0)
        tp = tp_new
        assert int(ts.step) == int(js.step) == step + 1
        assert ts.step.dtype == torch.int32
        _assert_trees_close(_port_np(tp), _np(jp), rtol=1e-6, atol=0)
        _assert_trees_close(_port_np(ts.mu), _np(js.mu), rtol=1e-6, atol=0)
        _assert_trees_close(_port_np(ts.nu), _np(js.nu), rtol=1e-6, atol=0)


# ------------------------------------------------------- (b) aggregate grads
def _agg_case(case):
    """(messages, dst, num_rows, reduce, valid, expected grads or None)."""
    rng = np.random.default_rng(0)
    if case in ("sum", "max"):
        e, v, f = 500, 200, 16
        dst = rng.integers(0, v, e)
        if case == "max":  # every row reached; continuous data, no ties
            dst = np.concatenate([np.arange(v), rng.integers(0, v, e - v)])
        msgs = rng.normal(size=(e, f)).astype(np.float32)
        return msgs, dst.astype(np.int32), v, case, None, None
    if case == "max ties":  # edges 0 and 1 tie on row 0
        msgs = np.array([[2.0], [2.0], [1.0], [5.0]], np.float32)
        return (msgs, np.array([0, 0, 0, 1], np.int32), 2, "max", None,
                [[0.5], [0.5], [0.0], [1.0]])
    # edge 1 ties the row max but the layout dropped it: not part of the max
    msgs = np.array([[2.0], [2.0], [5.0]], np.float32)
    return (msgs, np.array([0, 0, 1], np.int32), 2, "max",
            np.array([True, False, True]), [[1.0], [0.0], [1.0]])


@pytest.mark.parametrize("backend,case", [
    (b, c) for b in BACKENDS for c in ("sum", "max", "max ties")]
    + [("tiled", "max dropped tie")])
def test_aggregate_grads_match_reference(backend, case):
    msgs, dst, v, reduce, valid, expect = _agg_case(case)
    order, ldst, _ = prepare_tiled_edges(dst, v, valid=valid)
    square = case in ("sum", "max")

    def j_loss(m):
        out = j_ops.aggregate(m, jnp.asarray(dst), v,
                              edge_order=jnp.asarray(order),
                              local_dst=jnp.asarray(ldst), backend=backend,
                              reduce=reduce)
        return (out ** 2).sum() if square else out.sum(), out

    (_, j_out), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(msgs))
    m = torch.tensor(msgs, requires_grad=True)
    out = ops.aggregate(m, torch.as_tensor(dst, dtype=torch.int64), v,
                        edge_order=torch.as_tensor(order, dtype=torch.int64),
                        local_dst=torch.as_tensor(ldst), backend=backend,
                        reduce=reduce)
    loss = (out ** 2).sum() if square else out.sum()
    (grad,) = torch.autograd.grad(loss, m)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad),
                               rtol=1e-5, atol=1e-5)
    if expect is not None:
        np.testing.assert_allclose(grad.numpy(), expect, rtol=0, atol=0)


@pytest.mark.parametrize("case", ["sum", "max", "max dropped tie"])
def test_aggregate_without_graph_equals_function(case):
    """With no graph to record (inference_mode, as serving runs) the tiled
    aggregate skips the autograd Function; its output is the Function's
    bit for bit."""
    msgs, dst, v, reduce, valid, _ = _agg_case(case)
    order, ldst, _ = prepare_tiled_edges(dst, v, valid=valid)
    args = dict(edge_order=torch.as_tensor(order, dtype=torch.int64),
                local_dst=torch.as_tensor(ldst), backend="tiled",
                reduce=reduce)
    d = torch.as_tensor(dst, dtype=torch.int64)
    with_graph = ops.aggregate(torch.tensor(msgs, requires_grad=True), d, v,
                               **args)
    assert with_graph.grad_fn is not None
    with torch.inference_mode():
        without = ops.aggregate(torch.tensor(msgs), d, v, **args)
    assert without.grad_fn is None
    np.testing.assert_array_equal(without.numpy(),
                                  with_graph.detach().numpy())


def test_tiled_sum_output_takes_in_place_writes():
    """HaloSync completes an aggregate in place. When the row count is a
    multiple of the tile (no pad rows to cut), `sync.edge_aggregate`'s
    `.contiguous()` returns the aggregate itself, so the Function's output
    must be a tensor of its own, not a view autograd forbids writing."""
    rng = np.random.default_rng(0)
    e, v, f = 600, 512, 8
    dst = rng.integers(0, v, e)
    order, ldst, _ = prepare_tiled_edges(dst, v)
    m = torch.tensor(rng.normal(size=(e, f)).astype(np.float32),
                     requires_grad=True)
    out = ops.aggregate(m, torch.as_tensor(dst), v,
                        edge_order=torch.as_tensor(order, dtype=torch.int64),
                        local_dst=torch.as_tensor(ldst), backend="tiled")
    agg = out.reshape(2, 256, f)[:, :256].contiguous()
    agg.reshape(v, f).index_add_(0, torch.tensor([0, 1]), torch.ones(2, f))
    (grad,) = torch.autograd.grad(agg.sum(), m)
    np.testing.assert_array_equal(grad.numpy(), np.ones((e, f), np.float32))


# ------------------------------------------------- shared full-batch set-up
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
    assignment = partition_edges(jg, 4, "hep100", seed=1)
    return jg, tg, feats, labels, train, assignment


def _port_trainer(data, model, backend, k=4, sync_mode="halo"):
    _, tg, feats, labels, train, assignment = data
    if k == 1:
        assignment = np.zeros(tg.num_edges, np.int32)
    spec = tm.GNNSpec(model=model, agg_backend=backend, **DIMS)
    return t_fb.FullBatchTrainer.build(tg, assignment, k, spec, feats, labels,
                                       train, sync_mode=sync_mode, seed=SEED,
                                       device=CPU)


@pytest.fixture(scope="module")
def reference(data):
    """Per model, built once: the JAX trainer's vmap loss and gradients at
    its initial parameters, its 5-step loss trajectory and its final
    parameters (k=4, halo, hep100), on its tiled backend: off-TPU the jnp
    oracle under the `custom_vjp`s the port's Functions twin. Both of the
    port's backends are held to it (the reference's scatter backend equals
    its tiled one: tests/test_aggregate.py)."""
    jg, _, feats, labels, train, assignment = data
    cache = {}

    def get(model):
        if model not in cache:
            spec = jm.GNNSpec(model=model, agg_backend="tiled", **DIMS)
            tr = j_fb.FullBatchTrainer.build(jg, assignment, 4, spec, feats,
                                             labels, train, seed=SEED)
            loss, _ = j_fb.make_step_fns(spec, "halo", jg.num_vertices, 4)
            mapped = j_fb.wrap_spmd(loss, 4, "sim")
            loss0, grads = jax.jit(jax.value_and_grad(
                lambda p, b: jnp.mean(mapped(p, b))))(tr.params, tr.blocks)
            losses = [tr.train_step() for _ in range(STEPS)]
            cache[model] = dict(loss0=float(loss0), grads=_np(grads),
                                losses=losses, params=_np(tr.params))
        return cache[model]

    return get


# ------------------------------------------------------ (c) loss gradients
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model", MODELS)
def test_loss_grads_match_reference_k4_halo(data, reference, model, backend):
    ref = reference(model)
    tr = _port_trainer(data, model, backend)
    loss_of, _ = t_fb.make_step_fns(tr.spec, "halo", 4)
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


# ------------------------------------------------- (d) MFG GAT layer grads
def _mfg(backend):
    """A padded MFG layer: 40 source rows, 16 destination rows, 90 real and
    30 pad edges (pad src == n_src, pad dst == n_dst, masked)."""
    rng = np.random.default_rng(5)
    n_src, n_dst, n_pad, n_real = 40, 16, 120, 90
    esrc = rng.integers(0, n_src, n_pad).astype(np.int32)
    edst = rng.integers(0, n_dst, n_pad).astype(np.int32)
    esrc[n_real:], edst[n_real:] = n_src, n_dst
    emask = np.arange(n_pad) < n_real
    deg = np.zeros(n_dst + 1, np.float32)
    np.add.at(deg, edst[:n_real], 1.0)
    j_lay = dict(esrc=esrc, edst=edst, emask=emask, deg=deg)
    if backend != "scatter":
        order, ldst, _ = prepare_tiled_edges(edst, n_dst + 1, valid=emask)
        j_lay.update(agg_order=order.astype(np.int32), agg_ldst=ldst)
    t_lay = {n: torch.as_tensor(a) for n, a in j_lay.items()}
    # the port clamps pad sources to the last row, as JAX's gather does
    t_lay["esrc"] = torch.as_tensor(np.minimum(esrc, n_src - 1)).long()
    t_lay["edst"] = t_lay["edst"].long()
    if "agg_order" in t_lay:
        t_lay["agg_order"] = t_lay["agg_order"].long()
    return {n: jnp.asarray(a) for n, a in j_lay.items()}, t_lay, n_src, n_dst


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
def test_mfg_gat_layer_grads_match_reference(backend, final):
    j_lay, t_lay, n_src, n_dst = _mfg(backend)
    spec = jm.GNNSpec(model="gat", feature_dim=8, hidden_dim=8,
                      num_classes=10, num_layers=1)
    p = _np(jm.init_params(spec, seed=2))
    rng = np.random.default_rng(6)
    h_src = rng.normal(size=(n_src, 8)).astype(np.float32)
    w = rng.normal(size=(n_dst, 10)).astype(np.float32)

    def j_loss(p, h):
        out = j_mb._mb_gat_layer(p["layers"][0], h, j_lay, n_dst,
                                 final=final, backend=backend)
        return (out * w).sum(), out

    (_, j_out), (jg_p, jg_h) = jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(h_src))
    tp = tm.params_from_numpy(p, CPU)
    for t in tp["layers"][0].values():
        t.requires_grad_()
    th = torch.tensor(h_src, requires_grad=True)
    out = t_mb._mb_gat_layer(tp["layers"][0], th, t_lay, n_dst, final=final,
                             backend=backend)
    leaves = list(tp["layers"][0].values()) + [th]
    grads = torch.autograd.grad((out * torch.as_tensor(w)).sum(), leaves)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), **TOL)
    for name, g in zip(tp["layers"][0], grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg_p["layers"][0][name]),
                                   err_msg=name, **TOL)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jg_h), **TOL)


# ----------------------------------------- (e) distributed == the k=1 oracle
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model", MODELS)
def test_distributed_equals_single_within_port(data, model, backend):
    single = _port_trainer(data, model, backend, k=1)
    dist = _port_trainer(data, model, backend, k=4)
    np.testing.assert_allclose(dist.forward_logits_global(),
                               single.forward_logits_global(), **TOL)
    for step in range(3):
        l1, l4 = single.train_step(), dist.train_step()
        assert abs(l1 - l4) < 1e-4, (step, l1, l4)


# --------------------------------- (f) the trainer against the reference's
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("model", MODELS)
def test_trainer_trajectory_matches_reference(data, reference, model, backend):
    ref = reference(model)
    tr = _port_trainer(data, model, backend)
    losses = [tr.train_step() for _ in range(STEPS)]
    assert all(isinstance(x, float) for x in losses)
    for step, (a, b) in enumerate(zip(losses, ref["losses"])):
        assert abs(a - b) < 1e-4, (step, a, b)
    assert int(tr.opt_state.step) == STEPS
    # A parameter whose true gradient at the start is zero (GAT's last-layer
    # a_dst here: every score of that layer is on the identity side of its
    # leaky_relu, where the softmax does not see the destination's term)
    # gets a reference gradient of float noise, and Adam's first step moves
    # it by about lr on the sign of that noise: the reference itself ends
    # 2.5e-3 apart on it between k=1 and k=4. Every other parameter is held
    # at the reference's tolerance; those are held to Adam's step bound.
    port = _port_np(tr.params)
    lr = tr.lr
    for li, layer in enumerate(ref["params"]["layers"]):
        for name, expect in layer.items():
            got = port["layers"][li][name]
            if np.abs(ref["grads"]["layers"][li][name]).max() < 1e-7:
                assert np.isfinite(got).all()
                assert np.abs(got - expect).max() <= 2 * STEPS * lr, name
            else:
                np.testing.assert_allclose(got, expect,
                                           err_msg=f"layer {li} {name}",
                                           **TOL)


# ------------------------------------------------------------- (g)-(h) CLI
TINY = ["--graph", "OR", "--scale", "0.02", "--k", "4", "--features", "8",
        "--hidden", "8", "--classes", "4", "--layers", "2"]


@pytest.mark.parametrize("model,backend", [("sage", "scatter"),
                                           ("gat", "tiled")])
def test_cli_trains_on_cpu(model, backend, capsys):
    out = gnn_train.run(TINY + ["--device", "cpu", "--model", model,
                                "--agg-backend", backend, "--epochs", "6",
                                "--lr", "0.02"])
    assert out.trainer.lr == 0.02
    assert len(out.losses) == len(out.step_seconds) == 6
    assert all(np.isfinite(out.losses)) and out.losses[-1] < out.losses[0]
    assert out.peak_memory is None  # a device number only on the card
    assert out.estimate.epoch_time > 0 and out.trainer.spec.model == model
    text = capsys.readouterr().out
    for line in ("vertices", "partitioned in", "rf=", "vertex_bal=",
                 "paper-cluster epoch estimate", "epoch   5 loss"):
        assert line in text, line


def test_cli_module_entry_point_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.gnn_train", "--device",
         "cpu", *TINY, "--epochs", "2"], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "epoch   1 loss" in proc.stdout


def test_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    defaults = gnn_train.parser().parse_args([])
    # --lr unset: each regime's reference trainer default
    assert defaults.device == "cuda" and defaults.lr is None
    assert gnn_train.DEFAULT_LR == {"fullbatch": 1e-2, "minibatch": 1e-3}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnn_train.run(TINY)


@pytest.mark.parametrize("argv", [["--resume"], ["--ckpt-dir", "DIR"],
                                  ["--trace", "TRACE"], ["--out-json", "x"],
                                  ["--inject-fault", "crash@step:1"]])
def test_cli_refuses_unported_flags(argv, tmp_path, capsys):
    """The checkpoint, fault and trace flags parse and run on the CPU (an
    injected crash raises `WorkerCrash` from `run` after the FATAL line;
    `--trace` writes the timeline and its report); the reference CLI's
    flag the port has not ported (study rows) is not parsed, and `run`
    refuses it naming its ROADMAP item before any work starts."""
    argv = [str(tmp_path / "ck") if a == "DIR" else
            str(tmp_path / "t.json") if a == "TRACE" else a for a in argv]
    assert set(gnn_train.NOT_PORTED) == {"--out-json"}
    if argv[0] in gnn_train.NOT_PORTED:
        with pytest.raises(SystemExit):
            gnn_train.parser().parse_args(TINY + argv)
        with pytest.raises(NotImplementedError, match="queue 1, item 2"):
            gnn_train.run(TINY + argv + ["--device", "cpu"])
        return
    gnn_train.parser().parse_args(TINY + argv)
    cli = TINY + argv + ["--device", "cpu", "--epochs", "2"]
    if argv[0] == "--inject-fault":
        with pytest.raises(WorkerCrash):
            gnn_train.run(cli)
        assert "FATAL: injected worker crash at step 1" in \
            capsys.readouterr().out
        return
    out = gnn_train.run(cli)
    assert len(out.losses) == 2 and out.start_step == 0
    assert (out.checkpoints is not None) == (argv[0] == "--ckpt-dir")
    assert (out.trace_report is not None) == (argv[0] == "--trace")
    if out.trace_report is not None:
        assert out.trace_report.exit_code == 0
        load_trace(argv[1])
        assert json.load(open(argv[1] + ".report.json"))["counts"][
            "error"] == 0
    if out.checkpoints is not None:
        assert out.checkpoints.nbytes > 0
        assert len(out.checkpoints.save_seconds) == 2


@pytest.mark.parametrize("flag", ["--trace", "--out-json"])
def test_serve_cli_refuses_unported_flags(flag, tmp_path):
    """`--out-json` (study rows) is refused naming its ROADMAP item;
    `--trace` is ported: it writes the timeline and a clean report."""
    if flag == "--trace":
        path = str(tmp_path / "serve.json")
        out = gnn_serve.run(TINY + ["--smoke", "--device", "cpu",
                                    f"{flag}={path}"])
        assert out.trace_report.exit_code == 0
        assert load_trace(path)["otherData"]["schema"] == "gnn-trace/v1"
        return
    with pytest.raises(SystemExit):
        gnn_serve.parser().parse_args([flag, "x"])
    with pytest.raises(NotImplementedError, match="queue 1, item 2"):
        gnn_serve.run([f"{flag}=x", "--device", "cpu"])


def test_main_asks_for_expandable_segments(monkeypatch):
    """The CLI's process sets the allocator to expandable segments before
    CUDA starts (training's temporaries fragment fixed ones), unless the
    caller set an allocator config of their own; `run`, which libraries
    call, leaves the process's allocator alone."""
    seen = []
    monkeypatch.setattr(gnn_train, "run", lambda argv: seen.append(
        os.environ.get("PYTORCH_CUDA_ALLOC_CONF")))
    monkeypatch.delenv("PYTORCH_CUDA_ALLOC_CONF", raising=False)
    gnn_train.main(TINY)
    assert seen == ["expandable_segments:True"]
    monkeypatch.setenv("PYTORCH_CUDA_ALLOC_CONF", "max_split_size_mb:64")
    gnn_train.main(TINY)
    assert seen == ["expandable_segments:True", "max_split_size_mb:64"]

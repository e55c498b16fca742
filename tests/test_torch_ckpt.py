"""The port's checkpoint layer against the JAX package's, on the CPU.

  (a) twins of tests/test_ckpt.py on torch tensors: atomic publish past a
      mid-write kill, keep-last-k GC, the save cadence, bf16 round trips,
      the path-mismatch guard, stray step_* directories, the corrupt
      newest checkpoint falling back, metadata-only reads
  (b) the on-disk format is the reference's: for the same tree both
      packages write the same manifest (paths, leaf order, files, shapes,
      dtypes) and the same leaf arrays
  (c) checkpoints cross between the packages: a JAX trainer's checkpoint
      restores into the port's trainer, whose next 3 steps match the JAX
      trainer's own continuation (rtol=atol=2e-4, the trajectories'
      tolerance of tests/test_torch_training.py); a port trainer's
      checkpoint (with its int8 EF carry) restores into a JAX trainer's
      tree leaf for leaf
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt import checkpoint as j_ckpt  # noqa: E402
from repro.core.edge_partition import partition_edges  # noqa: E402
from repro.core.graph import paper_graph as j_paper_graph  # noqa: E402
from repro.gnn import fullbatch as j_fb  # noqa: E402
from repro.gnn import models as jm  # noqa: E402
from repro.optim import adam_init as j_adam_init  # noqa: E402
from repro_torch.ckpt import (  # noqa: E402
    CheckpointManager,
    checkpoint_extra,
    restore_latest,
    save_checkpoint,
)
from repro_torch.core.graph import paper_graph  # noqa: E402
from repro_torch.fault import corrupt_latest_checkpoint  # noqa: E402
from repro_torch.gnn import fullbatch as t_fb  # noqa: E402
from repro_torch.gnn import models as tm  # noqa: E402
from repro_torch.optim import adam_init  # noqa: E402

CPU = torch.device("cpu")
TOL = dict(rtol=2e-4, atol=2e-4)  # tests/test_gnn_distributed.py:38
DIMS = dict(feature_dim=16, hidden_dim=8, num_classes=5, num_layers=2)
SEED = 7


def _tree(shift=0.0):
    return {"params": {"w": torch.arange(6.0).reshape(2, 3) + shift,
                       "b": torch.ones(3) * (1.0 + shift)},
            "step": torch.tensor(int(shift), dtype=torch.int32)}


def _manifest(directory):
    (ck,) = [n for n in os.listdir(directory) if n.startswith("step_")]
    with open(os.path.join(directory, ck, "manifest.json")) as fh:
        return os.path.join(directory, ck), json.load(fh)


# ------------------------------------------- (a) twins of tests/test_ckpt.py
def test_atomic_publish_survives_mid_write_kill(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1.0))
    # a kill between the leaf writes and the rename: only a .tmp directory,
    # even one with a complete-looking manifest inside
    tmp = os.path.join(d, "step_0000000002.tmp")
    os.makedirs(tmp)
    np.save(os.path.join(tmp, "leaf_00000.npy"), np.zeros((3,)))
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump({"step": 2, "extra": {}, "leaves": []}, fh)

    step, restored = restore_latest(d, _tree())
    assert step == 1
    np.testing.assert_array_equal(restored["params"]["b"].numpy(), 2.0)

    CheckpointManager(d, keep=3, every=1)  # init GCs partial dirs
    assert not os.path.exists(tmp)
    assert os.path.exists(os.path.join(d, "step_0000000001"))


def test_keep_last_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, every=1)
    for s in range(7):
        mgr.maybe_save(s, _tree(float(s)))
    names = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert names == [f"step_{s:010d}" for s in (4, 5, 6)]
    step, restored = mgr.restore(_tree())
    assert step == 6
    assert restored["step"].dtype == torch.int32
    assert int(restored["step"]) == 6


def test_save_every_n(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=10, every=5)
    saved = [s for s in range(12) if mgr.maybe_save(s, _tree(float(s)))]
    assert saved == [0, 5, 10]
    assert mgr.maybe_save(12, _tree(), force=True) is not None


def test_bf16_round_trip(tmp_path):
    """bf16 leaves are widened to f32 on disk (NumPy cannot hold bf16) and
    cast back to the target leaf's dtype on restore; the JAX package
    restores the same file to the same values."""
    tree = {"w": torch.arange(8.0, dtype=torch.bfloat16) / 3.0,
            "v": torch.ones(4)}
    save_checkpoint(str(tmp_path), 0, tree)
    path, manifest = _manifest(str(tmp_path))
    by_path = {rec["path"]: rec for rec in manifest["leaves"]}
    assert by_path["w"]["dtype"] == "bfloat16"
    raw = np.load(os.path.join(path, by_path["w"]["file"]))
    assert raw.dtype == np.float32

    step, restored = restore_latest(
        str(tmp_path), {n: torch.zeros_like(t) for n, t in tree.items()})
    assert step == 0
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"], tree["w"])
    _, j_restored = j_ckpt.restore_latest(str(tmp_path), {
        "w": jnp.zeros(8, jnp.bfloat16), "v": jnp.zeros(4)})
    np.testing.assert_array_equal(np.asarray(j_restored["w"], np.float32),
                                  tree["w"].float().numpy())


def test_restore_rejects_path_mismatch(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"a": torch.ones(2),
                                       "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="mismatch at leaf 'b'"):
        restore_latest(str(tmp_path), {"a": torch.ones(2),
                                       "c": torch.zeros(2)})


def test_stray_step_dir_skipped_with_warning(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, _tree(3.0))
    stray = os.path.join(d, "step_final")
    os.makedirs(stray)
    with open(os.path.join(stray, "manifest.json"), "w") as fh:
        json.dump({"step": "final", "extra": {}, "leaves": []}, fh)
    with pytest.warns(UserWarning, match="step_final"):
        step, restored = restore_latest(d, _tree())
    assert step == 3
    assert int(restored["step"]) == 3


@pytest.mark.parametrize("mode", ["manifest", "truncate"])
def test_corrupt_newest_falls_back_to_previous(tmp_path, mode):
    """The corrupt-ckpt fault: a newest checkpoint without its manifest is
    skipped (restore falls back to the previous one); a truncated leaf is
    what a manifest-only scan cannot see, and its load fails loudly."""
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1.0))
    save_checkpoint(d, 2, _tree(2.0))
    path = corrupt_latest_checkpoint(d, mode=mode)
    assert path.endswith("step_0000000002")
    if mode == "manifest":
        step, restored = restore_latest(d, _tree())
        assert step == 1 and int(restored["step"]) == 1
    else:
        with pytest.raises(ValueError):
            restore_latest(d, _tree())
    assert corrupt_latest_checkpoint(str(tmp_path / "empty")) is None
    with pytest.raises(ValueError, match="unknown corruption mode"):
        corrupt_latest_checkpoint(d, mode="shred")


def test_checkpoint_extra_reads_metadata_only(tmp_path):
    d = str(tmp_path)
    assert checkpoint_extra(d) == (None, {})
    save_checkpoint(d, 7, _tree(7.0), extra={"epoch": 3, "step": 1,
                                             "has_ef": True})
    path, _ = _manifest(d)
    for n in os.listdir(path):
        if n.endswith(".npy"):
            os.remove(os.path.join(path, n))
    step, extra = checkpoint_extra(d)
    assert step == 7
    assert extra == {"epoch": 3, "step": 1, "has_ef": True}
    assert j_ckpt.checkpoint_extra(d) == (step, extra)


# ----------------------------------------------------- (b) the on-disk format
def _gat_state(device_tree):
    """A GAT model's {"params", "opt_state", "ef"} in one package's types:
    the dict keys of a layer are not in sorted order, the optimizer state
    is a NamedTuple, the EF carry stacked [3, ...]."""
    spec = tm.GNNSpec(model="gat", **DIMS)
    host = tm.init_params_numpy(spec, seed=1)
    if device_tree == "torch":
        params = tm.params_from_numpy(host, CPU)
        ef = {"layers": [{n: torch.full((3,) + t.shape, 0.5)
                          for n, t in layer.items()}
                         for layer in params["layers"]]}
        return {"params": params, "opt_state": adam_init(params), "ef": ef}
    params = jax.tree.map(jnp.asarray, host)
    ef = jax.tree.map(lambda p: jnp.full((3,) + p.shape, 0.5), params)
    return {"params": params, "opt_state": j_adam_init(params), "ef": ef}


def _trees(kind):
    if kind == "small":
        return _tree(2.0), {"params": {"w": jnp.arange(6.0).reshape(2, 3) + 2,
                                       "b": jnp.ones(3) * 3.0},
                            "step": jnp.asarray(2, jnp.int32)}
    if kind == "bf16":
        return ({"w": torch.arange(8.0, dtype=torch.bfloat16) / 3.0,
                 "v": torch.ones(4)},
                {"w": jnp.arange(8.0, dtype=jnp.bfloat16) / 3.0,
                 "v": jnp.ones(4)})
    if kind == "nested":
        return ({"z": [torch.ones(2), (torch.zeros(1), None)],
                 "a": {"y": torch.tensor(1.5), "x": torch.ones(1, 2)}},
                {"z": [jnp.ones(2), (jnp.zeros(1), None)],
                 "a": {"y": jnp.asarray(1.5), "x": jnp.ones((1, 2))}})
    return _gat_state("torch"), _gat_state("jax")


@pytest.mark.parametrize("kind", ["small", "bf16", "nested", "gat state"])
def test_manifest_matches_reference(tmp_path, kind):
    port_tree, jax_tree = _trees(kind)
    save_checkpoint(str(tmp_path / "port"), 5, port_tree, extra={"epoch": 5})
    j_ckpt.save_checkpoint(str(tmp_path / "jax"), 5, jax_tree,
                           extra={"epoch": 5})
    p_dir, p_man = _manifest(str(tmp_path / "port"))
    j_dir, j_man = _manifest(str(tmp_path / "jax"))
    assert p_man == j_man
    if kind == "gat state":
        paths = [rec["path"] for rec in p_man["leaves"]]
        assert paths[:5] == [f"ef/layers/0/{n}" for n in
                             ("a_dst", "a_src", "b", "w", "w_out")]
        assert "opt_state/.step" in paths
        assert paths.index("opt_state/.step") < paths.index(
            "params/layers/0/a_dst")
    for rec in p_man["leaves"]:
        a = np.load(os.path.join(p_dir, rec["file"]))
        b = np.load(os.path.join(j_dir, rec["file"]))
        assert a.dtype == b.dtype, rec
        np.testing.assert_array_equal(a, b, err_msg=rec["path"])


# ------------------------------------- (c) checkpoints cross the packages
@pytest.fixture(scope="module")
def data():
    jg = j_paper_graph("OR", scale=0.02, seed=0)
    tg = paper_graph("OR", scale=0.02, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(tg.num_vertices, 16)).astype(np.float32)
    labels = rng.integers(0, 5, tg.num_vertices).astype(np.int32)
    train = rng.random(tg.num_vertices) < 0.3
    assignment = partition_edges(jg, 4, "hep100", seed=1)
    return jg, tg, feats, labels, train, assignment


def _both(data, model, codec=None):
    jg, tg, feats, labels, train, a = data
    jspec = jm.GNNSpec(model=model, agg_backend="tiled", **DIMS)
    tspec = tm.GNNSpec(model=model, agg_backend="tiled", **DIMS)
    jtr = j_fb.FullBatchTrainer.build(jg, a, 4, jspec, feats, labels, train,
                                      seed=SEED, codec=codec)
    ttr = t_fb.FullBatchTrainer.build(tg, a, 4, tspec, feats, labels, train,
                                      seed=SEED, codec=codec, device=CPU)
    return jtr, ttr


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_jax_checkpoint_resumes_in_port(data, tmp_path, model):
    jtr, ttr = _both(data, model)
    for _ in range(2):
        jtr.train_step()
    j_ckpt.save_checkpoint(str(tmp_path), 1,
                           {"params": jtr.params, "opt_state": jtr.opt_state},
                           extra={"epoch": 1, "has_ef": False})
    expect = [jtr.train_step() for _ in range(3)]
    step, restored = restore_latest(
        str(tmp_path), {"params": ttr.params, "opt_state": ttr.opt_state})
    assert step == 1 and checkpoint_extra(str(tmp_path))[1]["epoch"] == 1
    ttr.params, ttr.opt_state = restored["params"], restored["opt_state"]
    assert ttr.opt_state.step.dtype == torch.int32
    assert int(ttr.opt_state.step) == 2
    got = [ttr.train_step() for _ in range(3)]
    np.testing.assert_allclose(got, expect, **TOL)


@pytest.mark.parametrize("model,codec", [("sage", None), ("gat", None),
                                         ("sage", "int8")])
def test_port_checkpoint_restores_in_jax(data, tmp_path, model, codec):
    jtr, ttr = _both(data, model, codec)
    for _ in range(2):
        ttr.train_step()
    tree = {"params": ttr.params, "opt_state": ttr.opt_state}
    target = {"params": jtr.params, "opt_state": jtr.opt_state}
    if codec is not None:
        tree["ef"] = ttr.ef_state
        target["ef"] = jtr._init_ef()
    save_checkpoint(str(tmp_path), 1, tree, extra={"epoch": 1})
    step, restored = j_ckpt.restore_latest(str(tmp_path), target)
    assert step == 1
    j_leaves, j_paths, _ = j_ckpt._flatten_with_paths(restored)
    _, manifest = _manifest(str(tmp_path))
    assert j_paths == [rec["path"] for rec in manifest["leaves"]]
    for leaf, rec in zip(j_leaves, manifest["leaves"]):
        port_leaf = _port_leaf(tree, rec["path"])
        assert np.asarray(leaf).dtype == port_leaf.numpy().dtype, rec
        np.testing.assert_array_equal(np.asarray(leaf), port_leaf.numpy(),
                                      err_msg=rec["path"])
    if codec is not None:
        assert np.asarray(restored["ef"]["layers"][0]["w_self"]).shape[0] == 4


def _port_leaf(tree, path):
    node = tree
    for part in path.split("/"):
        if part.startswith("."):
            node = getattr(node, part[1:])
        elif isinstance(node, list):
            node = node[int(part)]
        else:
            node = node[part]
    return node


def test_reshard_tree_places_each_leaf():
    """`elastic.reshard_tree` puts every leaf on the device its placement
    names, values and dtypes kept; mismatched trees are refused."""
    from repro_torch.ckpt.elastic import reshard_tree

    tree = {"embed": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "blocks": {"wq": torch.ones(2, 2),
                       "caches": [torch.zeros(3), (torch.ones(1),)]}}
    placements = {"embed": "cpu", "blocks": {
        "wq": torch.device("cpu"), "caches": ["cpu", ("cpu",)]}}
    out = reshard_tree(tree, placements)
    assert torch.equal(out["embed"], tree["embed"])
    assert out["embed"].dtype == torch.bfloat16
    assert torch.equal(out["blocks"]["wq"], torch.ones(2, 2))
    assert isinstance(out["blocks"]["caches"][1], tuple)
    assert all(t.device.type == "cpu" for t in (
        out["embed"], out["blocks"]["wq"], out["blocks"]["caches"][0]))
    with pytest.raises(ValueError, match="keys"):
        reshard_tree(tree, {"embed": "cpu"})
    with pytest.raises(ValueError, match="sequence"):
        reshard_tree([torch.ones(1)], ["cpu", "cpu"])
    with pytest.raises(TypeError, match="leaf"):
        reshard_tree({"n": np.ones(3)}, {"n": "cpu"})

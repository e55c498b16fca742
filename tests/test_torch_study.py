"""The port's study module (`repro_torch.core.study`) and the CLIs'
`--out-json` rows against the JAX package's, on the CPU.

Every row is held to the reference's row on the same inputs: the same
keys, and `==` on every column but the measured ones
(`study.MEASURED_COLUMNS`: clocks, and the CLI rows' `loss`, held within
LOSS_TOL). Partitions, sampled counts and cost-model inputs are
bit-identical in both packages, so every computed column must be too.
"""

import inspect
import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from repro.core import study as j_study  # noqa: E402
from repro.fault import FaultPlan as JPlan  # noqa: E402
from repro.gnn import models as jm  # noqa: E402
from repro.launch import gnn_serve as j_gnn_serve  # noqa: E402
from repro.launch import gnn_train as j_gnn_train  # noqa: E402
from repro_torch.core import study  # noqa: E402
from repro_torch.fault import FaultPlan  # noqa: E402
from repro_torch.gnn import models as tm  # noqa: E402
from repro_torch.launch import gnn_serve, gnn_train  # noqa: E402

LOSS_TOL = 1e-4  # tests/test_gnn_distributed.py:53
DIMS = dict(feature_dim=16, hidden_dim=8, num_classes=5, num_layers=2)
GRAPH = dict(scale=0.02)
K = 4
HOST_COLUMNS = ("host_sample_time", "host_fetch_time", "host_transfer_time",
                "host_compute_time", "host_step_wall", "overlap_efficiency")


def _strict(name):
    raise ValueError(f"non-strict JSON token {name}")


def _nan_equal(a, b) -> bool:
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(_nan_equal, a, b))
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def same_row(got: dict, want: dict) -> None:
    """One key set; every column outside MEASURED_COLUMNS exactly equal
    (NaN to NaN), `loss` within LOSS_TOL, and each measured column a
    number where the reference has one."""
    assert set(got) == set(want), set(got) ^ set(want)
    diff = {c: (got[c], want[c]) for c in want
            if c not in study.MEASURED_COLUMNS
            and not _nan_equal(got[c], want[c])}
    assert not diff, diff
    if "loss" in want:
        assert abs(got["loss"] - want["loss"]) < LOSS_TOL, (got["loss"],
                                                          want["loss"])
    for c in set(want) & set(study.MEASURED_COLUMNS):
        assert isinstance(got[c], float) == isinstance(want[c], float), c


@pytest.fixture(scope="module")
def caches():
    """One partition cache per package, shared by the module's rows."""
    return study.StudyCache(), j_study.StudyCache()


def specs(**kw):
    return tm.GNNSpec(**DIMS, **kw), jm.GNNSpec(**DIMS, **kw)


FULLBATCH = [(m, "halo", None) for m in study.EDGE_METHODS] + [
    ("hep100", "ring", None), ("hep100", "halo", "int8"),
    ("hdrf", "halo", "bf16")]


@pytest.mark.parametrize("method,sync_mode,codec", FULLBATCH)
def test_fullbatch_row_matches_reference(caches, method, sync_mode, codec):
    t, j = specs(model="sage")
    kw = dict(sync_mode=sync_mode, codec=codec, **GRAPH)
    got = study.fullbatch_row("OR", method, K, t, cache=caches[0], **kw)
    want = j_study.fullbatch_row("OR", method, K, j, cache=caches[1], **kw)
    same_row(got, want)
    assert got["method"] == ("blockrow" if sync_mode == "ring" else method)
    assert got["codec"] == (codec or "fp32")


def test_fullbatch_speedup_matches_reference(caches):
    t, j = specs(model="sage")
    got = study.fullbatch_speedup([
        study.fullbatch_row("OR", m, K, t, cache=caches[0], **GRAPH)
        for m in study.EDGE_METHODS])
    want = j_study.fullbatch_speedup([
        j_study.fullbatch_row("OR", m, K, j, cache=caches[1], **GRAPH)
        for m in study.EDGE_METHODS])
    assert [r["method"] for r in got] == list(study.EDGE_METHODS)
    for a, b in zip(got, want):
        same_row(a, b)
    assert got[0]["speedup"] == 1.0


def test_minibatch_row_fast_path_matches_reference(caches):
    t, j = specs(model="sage")
    kw = dict(cache_policy="degree", cache_budget=20, global_batch=64,
              steps=3, **GRAPH)
    got = study.minibatch_row("OR", "metis", K, t, cache=caches[0], **kw)
    want = j_study.minibatch_row("OR", "metis", K, j, cache=caches[1], **kw)
    same_row(got, want)
    assert got["cache_hits"] > 0 and "host_step_wall" not in got
    assert got["overlap"] is False


@pytest.mark.parametrize("overlap", [False, True], ids=["serial", "overlap"])
def test_minibatch_row_device_step_matches_reference(overlap):
    """The device step's row: sampled counts averaged over the steps, the
    six measured host columns beside them (fresh caches: the reference's
    and the port's partition seconds are their own)."""
    t, j = specs(model="gat", agg_backend="tiled")
    kw = dict(run_device_step=True, overlap=overlap, steps=2,
              global_batch=64, **GRAPH)
    got = study.minibatch_row("OR", "metis", K, t, cache=study.StudyCache(),
                              device="cpu", **kw)
    want = j_study.minibatch_row("OR", "metis", K, j,
                                 cache=j_study.StudyCache(), **kw)
    same_row(got, want)
    assert set(HOST_COLUMNS) <= set(got) <= set(want)
    assert got["overlap"] is overlap
    assert got["prefetch_depth"] == (2 if overlap else 0)


def test_minibatch_speedup_matches_reference(caches):
    t, j = specs(model="sage")
    kw = dict(global_batch=64, steps=2, **GRAPH)
    got = study.minibatch_speedup([
        study.minibatch_row("OR", m, K, t, cache=caches[0], **kw)
        for m in ("random", "metis")])
    want = j_study.minibatch_speedup([
        j_study.minibatch_row("OR", m, K, j, cache=caches[1], **kw)
        for m in ("random", "metis")])
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        same_row(a, b)
    # the paper's finding on this graph: metis fetches fewer remote rows
    assert got[1]["remote_pct_random"] < 100.0


SERVE = [("metis", None), ("hep100", None),
         ("hep100", "worker-death@t:0.05,worker:1")]


@pytest.mark.parametrize("method,death", SERVE,
                         ids=["metis", "hep100", "hep100-worker-death"])
def test_serve_row_matches_reference(caches, method, death):
    t, j = specs(model="gat", agg_backend="tiled")
    kw = dict(n_requests=80, qps=400.0, **GRAPH)
    plans = ((FaultPlan.parse([death]), JPlan.parse([death]))
             if death else (None, None))
    got = study.serve_row("OR", method, K, t, cache=caches[0],
                          device="cpu", fault_plan=plans[0],
                          detect_delay=0.005 if death else 0.0, **kw)
    want = j_study.serve_row("OR", method, K, j, cache=caches[1],
                             fault_plan=plans[1],
                             detect_delay=0.005 if death else 0.0, **kw)
    same_row(got, want)
    assert got["requests"] == 80
    assert ("rerouted" in got) == bool(death)
    if death:
        assert got["dead_worker"] == 1 and got["rerouted"] > 0


def test_rows_that_run_a_model_default_to_the_card(monkeypatch):
    """`minibatch_row`'s device step and `serve_row` take the card unless
    asked for the CPU, and raise when no GPU is visible; the embeddings
    memo is keyed by device, its parameters on that device."""
    for fn in (study.minibatch_row, study.serve_row):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    t, _ = specs(model="sage")
    cache = study.StudyCache()
    study.serve_row("OR", "metis", K, t, cache=cache, device="cpu",
                    n_requests=20, **GRAPH)
    g = cache.graph("OR", GRAPH["scale"], 0)
    [key] = cache._serve_embeddings
    assert key == (id(g), t, 0, torch.device("cpu"))
    params, _ = cache._serve_embeddings[key]
    assert all(p.device.type == "cpu" for lay in params["layers"]
               for p in lay.values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.serve_row("OR", "metis", K, t, cache=cache, n_requests=20,
                        **GRAPH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        study.minibatch_row("OR", "metis", K, t, cache=cache,
                            run_device_step=True, steps=1, **GRAPH)


def test_write_rows_bytes_match_reference(tmp_path):
    rows = [{"a": np.float32(1.5), "b": np.int64(7), "c": np.arange(3),
             "d": float("nan"), "e": float("inf"), "f": [np.float64(-np.inf),
                                                          2.0, None],
             "g": {"h": np.bool_(True), "i": (1, np.nan)}, "j": "text",
             "k": np.array([0.5, np.nan])},
            {"x": -0.0, "y": 1e-300, "z": True}]
    got, want = tmp_path / "port.json", tmp_path / "ref.json"
    study.write_rows(rows, str(got))
    j_study.write_rows(rows, str(want))
    assert got.read_bytes() == want.read_bytes()
    loaded = json.loads(got.read_text(), parse_constant=_strict)
    assert loaded[0]["d"] is None and loaded[0]["e"] is None
    assert loaded[0]["k"] == [0.5, None]


# ---------------------------------------------------------------------------
# the CLIs' --out-json rows against the reference CLI's
# ---------------------------------------------------------------------------

CLI = ["--graph", "OR", "--scale", "0.02", "--k", "4", "--features", "8",
       "--hidden", "8", "--classes", "4", "--layers", "2"]


def _reference_row(main, argv, path, monkeypatch) -> dict:
    monkeypatch.setattr(sys, "argv", ["gnn", *argv, "--out-json", path])
    main()
    [row] = json.loads(open(path).read(), parse_constant=_strict)
    return row


def _port_row(run, argv, path):
    out = run(argv + ["--device", "cpu", "--out-json", path])
    [row] = json.loads(open(path).read(), parse_constant=_strict)
    return out, row


@pytest.mark.parametrize("regime", ["fullbatch", "minibatch"])
def test_train_cli_row_matches_reference(regime, tmp_path, monkeypatch):
    """Full batch: the final loss beside the run's estimate. Mini batch
    over 2 epochs: the row averages the LAST epoch's steps only (its host
    phase means are those steps' `phase_means`, its loss their mean)."""
    argv = CLI + (["--regime", "minibatch", "--partitioner", "metis",
                   "--batch", "64", "--epochs", "2"]
                  if regime == "minibatch" else ["--epochs", "3"])
    out, got = _port_row(gnn_train.run, argv, str(tmp_path / "port.json"))
    want = _reference_row(j_gnn_train.main, argv, str(tmp_path / "ref.json"),
                          monkeypatch)
    same_row(got, want)
    if regime == "fullbatch":
        assert got["loss"] == out.losses[-1]
        return
    per_epoch = len(out.step_metrics) // 2
    last = out.step_metrics[per_epoch:]
    assert per_epoch > 1 and got["loss"] == float(np.mean(
        [s.loss for s in last]))
    for col, value in study.host_phase_means(last).items():
        assert got[col] == value, col
    assert got["host_step_wall"] != study.host_phase_means(
        out.step_metrics)["host_step_wall"]


def test_serve_cli_row_matches_reference(tmp_path, monkeypatch):
    argv = CLI + ["--model", "gat", "--agg-backend", "tiled", "--smoke",
                  "--partitioner", "metis", "--requests", "80"]
    out, got = _port_row(gnn_serve.run, argv, str(tmp_path / "port.json"))
    want = _reference_row(j_gnn_serve.main, argv, str(tmp_path / "ref.json"),
                          monkeypatch)
    same_row(got, want)
    assert got["partition_quality"] == out.partition_quality < 1.0


def test_resumed_minibatch_with_no_epoch_left_writes_no_row(tmp_path,
                                                           capsys):
    argv = CLI + ["--regime", "minibatch", "--partitioner", "metis",
                  "--batch", "64", "--epochs", "1", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path / "ck")]
    gnn_train.run(argv)
    path = tmp_path / "row.json"
    out = gnn_train.run(argv + ["--resume", "--out-json", str(path)])
    assert out.step_metrics == [] and not path.exists()
    assert "--out-json needs at least one trained epoch" in \
        capsys.readouterr().out

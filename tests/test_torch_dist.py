"""The port's dist mode (one process a partition, the twin of the
reference's `shard_map` mode) against the JAX package, on the CPU.

Four ranks over gloo (`launch/ranks.py`), spawned once for the module,
run every case (`gnn/dist_jobs.py`); meanwhile this process runs the
reference in its vmap sim mode and the port's sim. The reference's sizes
and tolerances (tests/test_dist_lowering.py: OR 0.01, dims 8, 4 classes,
hdrf seed 1, trainer seed 7; 2e-4 on logits and 1e-4 on losses against
an oracle, 1e-5 / 1e-6 between backends, 1e-5 for EF):

  (a) halo SAGE forward (scatter and tiled), ring SAGE and GAT (forward
      and two steps), dense GAT forward == the reference's vmap sim and
      its k=1 oracle; tiled == scatter after a step
  (b) every case's first gradient == the port's sim gradient (the
      lossless step's mean over the ranks is dL/dW), and a lossy (int8)
      step's per-rank gradients, losses, parameters and EF carry == the
      sim's
  (c) the tiled segment max on each rank == the reference's vmap scatter
      max; the int8 EF reduce over 6 steps == the reference's under vmap
  (d) the twins of the HLO byte pins from each rank's byte counter: halo
      fp32 2·k·B·d·4 a rank, ring fp32 k−1 shifts of (Vb+1)·d·4, ring
      int8 == `sync_wire_bytes_per_round` (< 0.3x fp32); halo int8 and
      dense beside them; a forward's bytes == the analytic accounting
  (e) bitwise pins inside the dist mode: fp32 codec == no codec, two runs
      the same bits, every rank the same parameters; no rank imported jax
  (f) failing fast: a rank that raises fails the launch, a launch past its
      timeout is killed, `nccl` with more ranks than cards raises at once
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import wire as j_wire  # noqa: E402
from repro.core.edge_partition import partition_edges as j_partition  # noqa: E402
from repro.core.graph import paper_graph as j_paper_graph  # noqa: E402
from repro.gnn import fullbatch as j_fb  # noqa: E402
from repro.gnn import models as jm  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.core.edge_partition import partition_edges  # noqa: E402
from repro_torch.core.graph import paper_graph  # noqa: E402
from repro_torch.gnn import dist_jobs  # noqa: E402
from repro_torch.gnn import fullbatch as t_fb  # noqa: E402
from repro_torch.gnn import models as tm  # noqa: E402
from repro_torch.gnn import sync as t_sync  # noqa: E402
from repro_torch.kernels import tiling  # noqa: E402
from repro_torch.launch import mesh as t_mesh  # noqa: E402
from repro_torch.launch import ranks  # noqa: E402

CPU = torch.device("cpu")
K = 4
DIMS = dict(feature_dim=8, hidden_dim=8, num_classes=4)
SEED = 7
LOGIT_TOL = 2e-4   # tests/test_dist_lowering.py:96
LOSS_TOL = 1e-4    # :216
BACKEND_TOL = (1e-5, 1e-6)  # logits, loss: :132
EF_TOL = 1e-5      # tests/test_wire.py:284
GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
D = 8              # the byte pins' width (test_dist_lowering.py:236)
EF_STEPS = 6

# (name, sync, model, backend, codec, steps, runs): the dist trainings
CASES = [
    ("halo sage scatter", "halo", "sage", "scatter", None, 1, 2),
    ("halo sage tiled", "halo", "sage", "tiled", None, 1, 1),
    ("halo sage scatter fp32", "halo", "sage", "scatter", "fp32", 1, 1),
    ("ring sage", "ring", "sage", "scatter", None, 2, 1),
    ("ring gat", "ring", "gat", "scatter", None, 2, 1),
    ("dense gat", "dense", "gat", "scatter", None, 1, 1),
    ("halo gat tiled", "halo", "gat", "tiled", None, 2, 2),
    ("halo sage int8", "halo", "sage", "tiled", "int8", 3, 1),
]
LOSSLESS = [c[0] for c in CASES if c[4] is None]
# (name, sync, codec): one aggregate's bytes
PINS = [("halo fp32", "halo", None), ("ring fp32", "ring", None),
        ("ring int8", "ring", "int8"), ("halo int8", "halo", "int8"),
        ("dense fp32", "dense", None)]


def _spec(model, backend="scatter"):
    return tm.GNNSpec(model=model, agg_backend=backend, **DIMS)


def _segment_inputs():
    """tests/test_dist_lowering.py:147-159's inputs: k layouts over 300
    rows, one shared per_tile, every row covered."""
    k, e, v, f = K, 400, 300, 8
    rng = np.random.default_rng(0)
    dst = np.stack([np.concatenate([rng.permutation(v),
                                    rng.integers(0, v, e - v)])
                    for _ in range(k)]).astype(np.int32)
    msgs = rng.normal(size=(k, e, f)).astype(np.float32)
    per_tile = max(tiling.prepare_tiled_edges(dst[p], v)[0].shape[0]
                   for p in range(k)) // tiling.tiled_shape(v)[1]
    lay = [tiling.prepare_tiled_edges(dst[p], v, per_tile=per_tile)[:2]
           for p in range(k)]
    return {"messages": msgs, "dst": dst, "rows": v,
            "order": np.stack([o for o, _ in lay]),
            "ldst": np.stack([ld for _, ld in lay])}


def _ef_seq():
    """tests/test_wire.py:252-256's stacked gradients, 6 steps."""
    rng = np.random.default_rng(0)
    return [{"w": rng.normal(size=(K, 6, 5)).astype(np.float32),
             "b": rng.normal(size=(K, 5)).astype(np.float32)}
            for _ in range(EF_STEPS)]


def _reference(g, a, feats, labels, train):
    """The JAX package's runs: vmap sim logits (before and after the
    case's steps) and losses, the k=1 oracle's, the scatter segment max
    under vmap and the int8 EF reduce under vmap."""
    out = {}
    for name, sync, model, backend, codec, steps, _ in CASES:
        if codec is not None or name == "halo gat tiled":
            continue
        spec = jm.GNNSpec(model=model, agg_backend=backend, **DIMS)
        tr = j_fb.FullBatchTrainer.build(
            g, a, K, spec, feats, labels, train, sync_mode=sync, seed=SEED)
        before = tr.forward_logits_global()
        if name == "dense gat":
            # the reference cannot differentiate its dense GAT (`lax.pmax`
            # has no rule): forward only, as its own tests hold it
            out[name] = (before, None, None)
            continue
        losses = [tr.train_step() for _ in range(steps)]
        out[name] = (before, losses, tr.forward_logits_global())
    for model in ("sage", "gat"):
        tr = j_fb.FullBatchTrainer.build(
            g, np.zeros(g.num_edges, np.int32), 1, _spec_j(model), feats,
            labels, train, seed=SEED)
        before = tr.forward_logits_global()
        out[f"oracle {model}"] = (before, [tr.train_step() for _ in range(2)])
    seg = _segment_inputs()
    out["segment"] = np.asarray(jax.vmap(lambda m, d: j_ops.aggregate(
        m, d, seg["rows"], backend="scatter", reduce="max"))(
            jnp.asarray(seg["messages"]), jnp.asarray(seg["dst"])))
    codec = j_wire.make_codec("int8")
    fn = jax.jit(jax.vmap(lambda g_, e: j_wire.codec_grad_reduce(
        codec, g_, e, "parts"), axis_name="parts"))
    seq = _ef_seq()
    ef = j_wire.ef_init(seq[0])
    steps = []
    for g_ in seq:
        mean, ef = fn(g_, ef)
        steps.append(jax.tree.map(np.asarray, (mean, ef)))
    out["ef"] = steps
    return out


def _spec_j(model):
    return jm.GNNSpec(model=model, **DIMS)


def _sim(book, spec, sync, codec, feats, labels, train, steps):
    """The port's sim trainer over the same book: first gradient (the
    lossy step's per-partition k * dL/dW_j), logits, losses, params, EF."""
    tr = t_fb.FullBatchTrainer.from_book(
        book, spec, feats, labels, train, sync_mode=sync, seed=SEED,
        codec=codec, device=CPU)
    loss_of, _ = tr._step_fns
    _, grads = tm.per_partition_grads(
        lambda p: loss_of(p, tr.blocks), tr.params, k=K,
        stacked=codec not in (None, "fp32"))
    before = tr.forward_logits_global()
    losses = [tr.train_step() for _ in range(steps)]
    np_tree = lambda t: [{n: x.detach().numpy() for n, x in layer.items()}  # noqa: E731
                         for layer in t["layers"]]
    return {"grads": np_tree(grads), "logits_before": before,
            "losses": losses, "params": np_tree(tr.params),
            "ef_state": None if tr.ef_state is None else np_tree(tr.ef_state)}


@pytest.fixture(scope="module")
def dist():
    """One launch of 4 gloo ranks running every case; the reference and
    the port's sim run here meanwhile."""
    g = paper_graph("OR", scale=0.01, seed=0)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(g.num_vertices, 8)).astype(np.float32)
    labels = rng.integers(0, 4, g.num_vertices).astype(np.int32)
    train = rng.random(g.num_vertices) < 0.3
    a = partition_edges(g, K, "hdrf", seed=1)
    problem = dict(features=feats, labels=labels, train_mask=train)
    books, jobs = {}, []
    for name, sync, model, backend, codec, steps, runs in CASES:
        key = (sync, backend != "scatter")
        if key not in books:
            books[key] = t_fb.build_book(g, a, K, sync_mode=sync,
                                         tiled_layout=key[1])
        jobs.append(("train", dict(
            book=books[key], spec=_spec(model, backend), sync_mode=sync,
            steps=steps, codec=codec, seed=SEED, runs=runs, grads=True,
            **problem)))
    pin_books = {"halo": books[("halo", False)],
                 "dense": books[("halo", False)],
                 "ring": books[("ring", False)]}
    for name, sync, codec in PINS:
        jobs.append(("aggregate", dict(book=pin_books[sync], sync_mode=sync,
                                       d=D, codec=codec)))
    jobs.append(("segment", _segment_inputs()))
    jobs.append(("ef_reduce", dict(
        seq=[{"layers": [s]} for s in _ef_seq()], codec="int8")))
    t0 = time.perf_counter()
    launch = ranks.start_ranks(dist_jobs.run_jobs, K, backend="gloo",
                               device="cpu", args=(jobs,), timeout=600)
    try:
        jg = j_paper_graph("OR", scale=0.01, seed=0)
        ref = _reference(jg, j_partition(jg, K, "hdrf", seed=1), feats,
                         labels, train)
        sims = {}
        for name, sync, model, backend, codec, steps, _ in CASES:
            sims[name] = _sim(books[(sync, backend != "scatter")],
                              _spec(model, backend), sync, codec, feats,
                              labels, train, steps)
    except BaseException:
        launch.close()
        raise
    per_rank = launch.join()
    names = [c[0] for c in CASES] + [f"pin {p[0]}" for p in PINS] + [
        "segment", "ef"]
    out = {name: [per_rank[r][i] for r in range(K)]
           for i, name in enumerate(names)}
    return {"dist": out, "ref": ref, "sim": sims, "books": pin_books,
            "seconds": time.perf_counter() - t0}


def _run(dist, name, rank=0, run=0):
    return dist["dist"][name][rank]["runs"][run]


# ------------------------------------------------------------------- (a)
@pytest.mark.parametrize("name", ["halo sage scatter", "halo sage tiled",
                                  "ring sage", "ring gat", "dense gat"])
def test_dist_forward_matches_reference(dist, name):
    """Dist logits == the reference's vmap sim at 2e-4 (its shard_map
    pin), before and after the case's steps."""
    ref_before, _, ref_after = dist["ref"][name]
    got = _run(dist, name)
    np.testing.assert_allclose(got["logits_before"], ref_before,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    if ref_after is not None:
        np.testing.assert_allclose(got["logits_after"], ref_after,
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("name", ["halo sage scatter", "halo sage tiled",
                                  "ring sage", "ring gat"])
def test_dist_losses_match_reference(dist, name):
    """Dist losses == the reference's vmap sim at 1e-4 a step."""
    _, ref_losses, _ = dist["ref"][name]
    got = _run(dist, name)["losses"]
    assert len(got) == len(ref_losses)
    np.testing.assert_allclose(got, ref_losses, rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_dist_ring_matches_k1_oracle(dist, model):
    """Ring under 4 ranks == the reference's k=1 oracle: forward at 2e-4,
    two steps' losses at 1e-4 (tests/test_dist_lowering.py:186)."""
    before, losses = dist["ref"][f"oracle {model}"]
    got = _run(dist, f"ring {model}")
    np.testing.assert_allclose(got["logits_before"], before,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=LOSS_TOL)


def test_dist_halo_sage_matches_k1_oracle(dist):
    before, _ = dist["ref"]["oracle sage"]
    np.testing.assert_allclose(_run(dist, "halo sage scatter")["logits_before"],
                               before, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_dist_tiled_equals_scatter(dist):
    """The tiled backend == the scatter backend within the dist mode after
    one step (tests/test_dist_lowering.py:101): logits 1e-5, loss 1e-6."""
    tiled, scatter = (_run(dist, "halo sage tiled"),
                      _run(dist, "halo sage scatter"))
    assert np.abs(tiled["logits_after"]
                  - scatter["logits_after"]).max() < BACKEND_TOL[0]
    assert abs(tiled["losses"][0] - scatter["losses"][0]) < BACKEND_TOL[1]


# ------------------------------------------------------------------- (b)
@pytest.mark.parametrize("name", LOSSLESS)
def test_dist_gradients_equal_sim(dist, name):
    """The dist step's gradient (every rank's k * dL/dW_j, averaged over
    the ranks) == the port's sim gradient dL/dW of the same mean loss, on
    every rank; losses and logits == the sim's."""
    sim = dist["sim"][name]
    for rank in range(K):
        got = _run(dist, name, rank)["grads"]["layers"]
        for li, (g_layer, s_layer) in enumerate(zip(got, sim["grads"])):
            for key in s_layer:
                np.testing.assert_allclose(
                    g_layer[key], s_layer[key], **GRAD_TOL,
                    err_msg=f"{name} rank {rank} layer {li} {key}")
    run = _run(dist, name)
    np.testing.assert_allclose(run["losses"], sim["losses"], rtol=0,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(run["logits_before"], sim["logits_before"],
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_dist_lossy_step_matches_sim(dist):
    """int8 on halo: rank j's gradient == the sim's per-partition gradient
    j; three EF steps' losses, parameters and each rank's EF carry == the
    sim's (the carry's partition j)."""
    name = "halo sage int8"
    sim = dist["sim"][name]
    for rank in range(K):
        run = _run(dist, name, rank)
        for li, s_layer in enumerate(sim["grads"]):
            for key in s_layer:
                np.testing.assert_allclose(
                    run["grads"]["layers"][li][key], s_layer[key][rank],
                    **GRAD_TOL, err_msg=f"rank {rank} layer {li} {key}")
                np.testing.assert_allclose(
                    run["ef_state"]["layers"][li][key],
                    sim["ef_state"][li][key][rank], rtol=0, atol=EF_TOL)
                np.testing.assert_allclose(
                    run["params"]["layers"][li][key],
                    sim["params"][li][key], rtol=0, atol=EF_TOL)
    np.testing.assert_allclose(_run(dist, name)["losses"], sim["losses"],
                               rtol=0, atol=LOSS_TOL)


# ------------------------------------------------------------------- (c)
def test_dist_segment_max_tiled_matches_reference(dist):
    """The tiled segment max on each rank's layout == the reference's
    scatter max under vmap (tests/test_dist_lowering.py:137), 1e-6."""
    got = np.stack(dist["dist"]["segment"])
    assert np.isfinite(got).all()
    assert np.abs(got - dist["ref"]["segment"]).max() < 1e-6


def test_dist_int8_ef_reduce_matches_reference_vmap(dist):
    """`codec_grad_reduce` (int8, EF) over 4 ranks, 6 steps == the
    reference's under vmap, step for step (tests/test_wire.py:246)."""
    for step, (ref_mean, ref_ef) in enumerate(dist["ref"]["ef"]):
        for rank in range(K):
            mean, ef = dist["dist"]["ef"][rank][step]
            for key in ("w", "b"):
                np.testing.assert_allclose(
                    mean["layers"][0][key], ref_mean[key][rank], rtol=0,
                    atol=EF_TOL, err_msg=f"step {step} rank {rank} mean")
                np.testing.assert_allclose(
                    ef["layers"][0][key], ref_ef[key][rank], rtol=0,
                    atol=EF_TOL, err_msg=f"step {step} rank {rank} ef")


# ------------------------------------------------------------------- (d)
def _pin(dist, name):
    return [dist["dist"][f"pin {name}"][r] for r in range(K)]


def test_dist_halo_fp32_bytes_pin(dist):
    """Each rank hands 2·k·B·d·4 bytes per reduce+broadcast pair, in two
    all-to-alls; times k == `sync_bytes_per_round(book, d, "halo")`
    (tests/test_dist_lowering.py:297)."""
    book = dist["books"]["halo"]
    for res in _pin(dist, "halo fp32"):
        assert res["calls"] == {"all-to-all": 2}
        assert res["sent"] == {"all-to-all": 2 * K * book.bucket * D * 4}
        assert res["sent"]["all-to-all"] * K == t_sync.sync_bytes_per_round(
            book, D, "halo")


def test_dist_ring_fp32_bytes_pin(dist):
    """Exactly k−1 shifts of (Vb+1)·d·4 bytes a rank (the last rotation
    left out); times k == `ring_bytes_per_round`
    (tests/test_dist_lowering.py:222)."""
    book = dist["books"]["ring"]
    for res in _pin(dist, "ring fp32"):
        assert res["calls"] == {"collective-permute": K - 1}
        assert res["sent"]["collective-permute"] == (
            (K - 1) * (book.v_block + 1) * D * 4)
        assert res["sent"]["collective-permute"] * K == \
            t_sync.ring_bytes_per_round(book, D)


def test_dist_ring_int8_bytes_pin(dist):
    """Under int8 the k−1 shifts move the int8 block and its scale: times
    k == `sync_wire_bytes_per_round(..., codec="int8")`, under 0.3x the
    fp32 figure (tests/test_dist_lowering.py:258)."""
    book = dist["books"]["ring"]
    for res in _pin(dist, "ring int8"):
        got = res["sent"]["collective-permute"] * K
        assert K - 1 <= res["calls"]["collective-permute"] <= 2 * (K - 1)
        assert got == t_sync.sync_wire_bytes_per_round(book, D, "ring",
                                                       codec="int8")
        assert got < 0.3 * t_sync.ring_bytes_per_round(book, D)


def test_dist_halo_int8_and_dense_bytes(dist):
    """Halo int8: the int8 buckets and the gathered sender scales, times k
    == `sync_wire_bytes_per_round`; dense: one all-reduce of [V+1, d]
    fp32 a rank, times k == `collective_budget`'s cluster bytes."""
    book = dist["books"]["halo"]
    for res in _pin(dist, "halo int8"):
        assert res["calls"] == {"all-to-all": 2, "all-gather": 2}
        assert sum(res["sent"].values()) * K == \
            t_sync.sync_wire_bytes_per_round(book, D, "halo", codec="int8")
    budget = t_sync.collective_budget(book, D, "dense")["all-reduce"]
    for res in _pin(dist, "dense fp32"):
        assert res["calls"] == {"all-reduce": 1}
        assert res["sent"]["all-reduce"] * K == budget["cluster_bytes"]


@pytest.mark.parametrize("name", ["halo sage scatter", "ring gat",
                                  "halo gat tiled"])
def test_dist_forward_bytes_match_accounting(dist, name):
    """One forward pass hands each rank's collectives
    Σ sync_bytes_per_round(book, d, mode) / k over its aggregates
    (`GNNSpec.aggregate_dims`)."""
    case = next(c for c in CASES if c[0] == name)
    sync, model, backend = case[1:4]
    book = t_fb.build_book(*_graph_and_assignment(), K, sync_mode=sync,
                           tiled_layout=backend != "scatter")
    want = sum(t_sync.sync_bytes_per_round(book, d, sync)
               for dims in _spec(model).aggregate_dims(sync) for d in dims)
    for rank in range(K):
        sent = _run(dist, name, rank)["forward_sent"]
        assert sum(sent.values()) * K == want, (rank, sent, want)


def _graph_and_assignment():
    g = paper_graph("OR", scale=0.01, seed=0)
    return g, partition_edges(g, K, "hdrf", seed=1)


# ------------------------------------------------------------------- (e)
def _same_bits(a, b, what):
    for li, (la, lb) in enumerate(zip(a["layers"], b["layers"])):
        for key in la:
            assert np.array_equal(la[key], lb[key]), f"{what}: {li} {key}"


def test_dist_fp32_codec_is_no_codec_bitwise(dist):
    plain, fp32 = (_run(dist, "halo sage scatter"),
                   _run(dist, "halo sage scatter fp32"))
    assert plain["losses"] == fp32["losses"]
    _same_bits(plain["params"], fp32["params"], "fp32 vs no codec")
    assert np.array_equal(plain["logits_after"], fp32["logits_after"])


@pytest.mark.parametrize("name", ["halo sage scatter", "halo gat tiled"])
def test_dist_runs_repeat_bitwise(dist, name):
    """A second dist run from scratch repeats the first bit for bit:
    losses and final parameters, on every rank."""
    for rank in range(K):
        a, b = _run(dist, name, rank, 0), _run(dist, name, rank, 1)
        assert a["losses"] == b["losses"]
        _same_bits(a["params"], b["params"], f"{name} rank {rank}")


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_dist_ranks_agree(dist, name):
    """Every rank reports the same losses and holds the same parameters
    after the step (the mean gradient is the same bits everywhere), and
    no rank imported jax."""
    base = _run(dist, name, 0)
    for rank in range(K):
        assert dist["dist"][name][rank]["jax_loaded"] is False
        run = _run(dist, name, rank)
        assert run["losses"] == base["losses"]
        _same_bits(run["params"], base["params"], f"{name} rank {rank}")
        # the kernel is the card's: the CPU ranks take its plain version
        assert run["launches"] == {}


# ------------------------------------------------------------------- (f)
def test_rank_that_raises_fails_the_launch():
    """Rank 1 raises in its first job while the others go on into a
    collective: the launch raises `RankError` with rank 1's traceback
    within the timeout, and kills the waiting ranks."""
    seg = _segment_inputs()
    seg["messages"] = seg["messages"][:1]  # rank 1 indexes past the end
    jobs = [("segment", seg), ("ef_reduce", dict(
        seq=[{"layers": [s]} for s in _ef_seq()[:1]], codec="int8"))]
    t0 = time.perf_counter()
    with pytest.raises(ranks.RankError, match="IndexError"):
        ranks.run_ranks(dist_jobs.run_jobs, 2, backend="gloo", device="cpu",
                        args=(jobs,), timeout=120)
    assert time.perf_counter() - t0 < 120


def test_launch_past_its_timeout_is_killed():
    t0 = time.perf_counter()
    launch = ranks.start_ranks(dist_jobs.run_jobs, 2, backend="gloo",
                               device="cpu", args=([],), timeout=0.5)
    with pytest.raises(TimeoutError):
        launch.join()
    assert all(p.poll() is not None for p in launch.procs)
    assert time.perf_counter() - t0 < 30


def test_nccl_needs_a_card_per_rank():
    """`nccl` with more ranks than visible cards raises before any
    rendezvous (nothing waits); so does a target outside the package."""
    with pytest.raises(RuntimeError, match="one card per rank"):
        t_mesh.make_mesh((K,), ("parts",), backend="nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        t_mesh.make_mesh((K,), ("parts",), backend="mpi")
    with pytest.raises(ValueError, match="one axis"):
        t_mesh.make_mesh((2, 2), ("data", "model"), backend="gloo")
    with pytest.raises(ValueError, match="module-level function"):
        ranks.start_ranks(np.zeros, 2, device="cpu")


def test_dist_mode_needs_a_matching_mesh():
    g, a = _graph_and_assignment()
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(g.num_vertices, 8)).astype(np.float32)
    zeros = np.zeros(g.num_vertices, np.int32)
    args = (g, a, K, _spec("sage"), feats, zeros, zeros.astype(bool))
    with pytest.raises(ValueError, match="one rank a partition"):
        t_fb.FullBatchTrainer.build(*args, mode="dist")
    one = t_mesh.Mesh(rank=0, size=2, backend="gloo", device=CPU)
    with pytest.raises(ValueError, match="one rank a partition"):
        t_fb.FullBatchTrainer.build(*args, mode="dist", mesh=one)
    with pytest.raises(ValueError, match="unknown mode"):
        t_fb.FullBatchTrainer.build(*args, mode="shard_map", device=CPU)
    with pytest.raises(ValueError, match="belongs to mode 'dist'"):
        t_fb.FullBatchTrainer.build(*args, mesh=one, device=CPU)


def test_rank_blocks_are_slices_of_the_stack():
    """A rank's block is the stacked block's slice: the same features,
    tables and tiled layout (so the kernel's layout and the all-to-all
    splits are the sim's), rows counted from 0."""
    g, a = _graph_and_assignment()
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(g.num_vertices, 8)).astype(np.float32)
    labels = rng.integers(0, 4, g.num_vertices).astype(np.int32)
    train = rng.random(g.num_vertices) < 0.3
    for sync in ("halo", "ring"):
        book = t_fb.build_book(g, a, K, sync_mode=sync, tiled_layout=True)
        stacked = t_fb.build_device_blocks(book, feats, labels, train,
                                           device=CPU)
        for p in range(K):
            one = t_fb.build_device_blocks(book, feats, labels, train,
                                           device=CPU, part=p)
            for field in ("x", "labels", "train_mask", "degree", "vmask",
                          "vglobal"):
                assert torch.equal(getattr(one, field)[0],
                                   getattr(stacked, field)[p]), field
            if sync == "halo":
                assert torch.equal(one.agg_ldst, stacked.agg_ldst.reshape(
                    K, -1)[p])
                assert torch.equal(one.send_idx[0], stacked.send_idx[p])
            else:
                assert torch.equal(one.agg_ldst, stacked.agg_ldst.reshape(
                    K, K, -1)[:, p])
                n = book.v_block + 1
                assert torch.equal(one.ring_dst, stacked.ring_dst.reshape(
                    K, K, -1)[:, p] - p * n)
    with pytest.raises(ValueError, match="partition 4"):
        t_fb.build_device_blocks(book, feats, labels, train, device=CPU,
                                 part=K)


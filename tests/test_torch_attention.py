"""The port's attention entry points against the JAX package's, on the CPU.

A CPU tensor takes the kernels' plain PyTorch versions, so here the port's
`ops.flash_attention` / `ops.decode_attention` are held against
`repro.kernels.ops` on two JAX paths: the Pallas kernel body in interpret
mode (`interpret=True`) and the jnp oracle (`repro.kernels.ref`). Inputs
are made with NumPy from a seed and handed to both. The shapes are those of
tests/test_kernels.py; the tolerances are its own (fp32 rtol 2e-5 / atol
1e-4, bf16 rtol 3e-2 / atol 0.15). The CUDA kernels themselves run only on
the card (chip_smoke.py holds them against the same plain versions there).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import decode_attention as decode  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2, 0.15)}


def _both(arr, dtype):
    """One float32 NumPy array as a JAX and a torch tensor of `dtype` (the
    same round-to-nearest-even to bf16 on both sides)."""
    jdt, tdt, _, _ = DTYPES[dtype]
    return jnp.asarray(arr, jdt), torch.as_tensor(arr).to(tdt)


def _assert_close(out, expect, dtype):
    _, _, rtol, atol = DTYPES[dtype]
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(expect, np.float32),
                               rtol=rtol, atol=atol)


def _attn_inputs(seed, q_shape, kv_shape, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=q_shape).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32)]
    pairs = [_both(a, dtype) for a in arrs]
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,sq,skv,d", [
    (1, 2, 256, 256, 64),
    (2, 1, 512, 512, 128),
    (1, 2, 256, 1024, 64),   # cross-ish (longer kv)
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_jax(b, h, sq, skv, d, dtype, causal):
    """tests/test_kernels.py's flash sweep: the port's plain path against
    the Pallas body in interpret mode and the oracle. Causal with
    Sq != Skv, where those two disagree, raises on the port."""
    (jq, jk, jv), (q, k, v) = _attn_inputs(b * h + sq + d, (b, h, sq, d),
                                           (b, h, skv, d), dtype)
    if causal and sq != skv:
        with pytest.raises(ValueError, match="Sq == Skv"):
            ops.flash_attention(q, k, v, causal=True)
        return
    out = ops.flash_attention(q, k, v, causal=causal)
    assert out.shape == (b, h, sq, d) and out.dtype == q.dtype
    _assert_close(out, jops.flash_attention(jq, jk, jv, causal=causal,
                                            interpret=True), dtype)
    _assert_close(out, jref.flash_attention_ref(jq, jk, jv, causal=causal),
                  dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,s,d,valid", [
    (1, 2, 1024, 64, 700),
    (2, 4, 2048, 128, 2048),
    (1, 1, 1024, 64, 1),
])
def test_decode_attention_matches_jax(b, h, s, d, valid, dtype):
    """tests/test_kernels.py's decode sweep, valid_len as an int and as a
    0-d tensor, against the Pallas body in interpret mode and the oracle."""
    (jq, jk, jv), (q, k, v) = _attn_inputs(s + d + valid, (b, h, d),
                                           (b, h, s, d), dtype)
    expect_pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(valid),
                                          interpret=True)
    expect_ref = jref.decode_attention_ref(jq, jk, jv, valid)
    for vl in (valid, torch.tensor(valid)):
        out = ops.decode_attention(q, k, v, vl)
        assert out.shape == (b, h, d) and out.dtype == q.dtype
        _assert_close(out, expect_pallas, dtype)
        _assert_close(out, expect_ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("edge", ["zero", "one", "full", "past_end"])
def test_decode_valid_len_edges(edge, dtype):
    """valid_len 0, 1, S and S + 5 against the JAX oracle. At 0 every slot
    is masked alike, so the result is the mean of v over all S slots (not
    zeros); past S every slot is valid."""
    b, h, s, d = 2, 2, 96, 64
    valid = {"zero": 0, "one": 1, "full": s, "past_end": s + 5}[edge]
    (jq, jk, jv), (q, k, v) = _attn_inputs(valid + 17, (b, h, d),
                                           (b, h, s, d), dtype)
    out = ops.decode_attention(q, k, v, valid)
    _assert_close(out, jref.decode_attention_ref(jq, jk, jv, valid), dtype)
    if edge == "zero":
        _assert_close(out, v.float().mean(dim=2).numpy(), dtype)
    if edge == "past_end":
        _assert_close(out, ops.decode_attention(q, k, v, s).float().numpy(),
                      dtype)


def test_causal_needs_square_inputs():
    """Causal with Sq != Skv raises ValueError on every path: the ops, the
    kernel wrapper and its plain version."""
    q, kv = torch.zeros(1, 2, 8, 64), torch.zeros(1, 2, 16, 64)
    for use_pallas in (None, False):
        with pytest.raises(ValueError, match="Sq == Skv"):
            ops.flash_attention(q, kv, kv, causal=True, use_pallas=use_pallas)
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash.flash_attention_plain(q[0], kv[0], kv[0], causal=True)
    with pytest.raises(ValueError, match="Sq == Skv"):
        flash.flash_attention(q[0], kv[0], kv[0], causal=True)
    # non-causal cross attention is fine
    assert ops.flash_attention(q, kv, kv, causal=False).shape == q.shape


def test_use_pallas_true_raises_on_cpu_tensors():
    """use_pallas=True forces the CUDA kernel: on CPU tensors it raises
    rather than falling back to the plain version; the kernel wrappers
    refuse CPU tensors too."""
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(ValueError, match="use_pallas=True"):
        ops.flash_attention(q, q, q, use_pallas=True)
    with pytest.raises(ValueError, match="use_pallas=True"):
        ops.decode_attention(q[:, :, 0], q, q, 4, use_pallas=True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode.decode_attention(q[0, :, 0], q[0], q[0], 4)


def test_use_pallas_false_is_the_plain_version():
    (_, _, _), (q, k, v) = _attn_inputs(3, (1, 2, 32, 64), (1, 2, 32, 64),
                                        "float32")
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, use_pallas=False),
        ops.flash_attention(q, k, v))
    torch.testing.assert_close(
        ops.decode_attention(q[:, :, 0], k, v, 5, use_pallas=False),
        ops.decode_attention(q[:, :, 0], k, v, 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_ref_twins_equal_jax_ref(causal, dtype):
    """The port's ref.py attention oracles equal repro.kernels.ref's on the
    same inputs, a non-square causal call (the oracle's bottom-right mask)
    and an explicit scale included."""
    (jq, jk, jv), (q, k, v) = _attn_inputs(5, (2, 3, 48, 64), (2, 3, 80, 64),
                                           dtype)
    _assert_close(ref.flash_attention_ref(q, k, v, causal=causal),
                  jref.flash_attention_ref(jq, jk, jv, causal=causal), dtype)
    _assert_close(ref.flash_attention_ref(q, k, v, causal=causal, scale=0.3),
                  jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                           scale=0.3), dtype)
    for valid in (0, 33, 80, 200):
        _assert_close(ref.decode_attention_ref(q[:, :, 0], k, v, valid),
                      jref.decode_attention_ref(jq[:, :, 0], jk, jv, valid),
                      dtype)


def test_plain_versions_take_folded_tensors():
    """flash_attention_plain / decode_attention_plain compute the ops on
    [BH, S, D] / [BH, D] folds."""
    (_, _, _), (q, k, v) = _attn_inputs(9, (2, 3, 40, 64), (2, 3, 40, 64),
                                        "float32")
    fold = lambda x: x.reshape(6, x.shape[2], 64)  # noqa: E731
    torch.testing.assert_close(
        flash.flash_attention_plain(fold(q), fold(k), fold(v), causal=True),
        fold(ops.flash_attention(q, k, v, causal=True)))
    torch.testing.assert_close(
        decode.decode_attention_plain(q[:, :, 0].reshape(6, 64), fold(k),
                                      fold(v), torch.tensor(17)),
        ops.decode_attention(q[:, :, 0], k, v, 17).reshape(6, 64))


def test_kernel_wrappers_check_shapes_before_launch():
    q = torch.zeros(4, 8, 64)
    with pytest.raises(ValueError, match="want"):
        flash.flash_attention(q[0], q, q)
    with pytest.raises(ValueError, match="differ"):
        flash.flash_attention(q, torch.zeros(4, 8, 32), torch.zeros(4, 8, 32),
                              causal=False)
    with pytest.raises(ValueError, match="does not match"):
        decode.decode_attention(torch.zeros(3, 64), q, q, 2)
    with pytest.raises(TypeError, match="valid_len"):
        decode.decode_attention_plain(q[:, 0], q, q, torch.tensor([2, 3]))


def test_sources_exist_build_raises_without_nvcc_and_counters_stay_zero(
        monkeypatch, tmp_path):
    """The CUDA sources ship in the package; building without nvcc raises
    (nothing falls back); a CPU run never counts a launch."""
    for mod, name in ((flash, "flash_attention"),
                      (decode, "decode_attention")):
        text = mod.LIBRARY.source.read_text()
        assert 'extern "C"' in text and "sm_90a" in text
        assert f"{name}_error_string" in text
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash.LIBRARY.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all([decode.LIBRARY])
    before = (dict(flash.LAUNCHES), dict(decode.LAUNCHES))
    q = torch.zeros(1, 2, 8, 64)
    ops.flash_attention(q, q, q)
    ops.decode_attention(q[:, :, 0], q, q, 3)
    assert (dict(flash.LAUNCHES), dict(decode.LAUNCHES)) == before


def _cuda_tiles():
    """The flash kernel's q tile and key tiles by dtype, read from its
    source (csrc/flash_attention.cu)."""
    import re
    text = flash.LIBRARY.source.read_text()
    const = {name: int(val) for name, val in
             re.findall(r"constexpr int (k\w+Block[QK]) = (\d+);", text)}
    return (const["kBfBlockQ"], const["kF32BlockQ"],
            {"bfloat16": const["kBfBlockK"], "float32": const["kF32BlockK"]})


# Sq = Skv one short of the 128-row q tile, one past it and one past two;
# and a non-causal Skv past two key tiles that is no multiple of them
STRADDLE = [(s, s, d, causal) for s in (127, 129, 257) for d in (64, 128)
            for causal in (True, False)] + [(200, 1000, 64, False),
                                            (200, 1000, 128, False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,d,causal", STRADDLE)
def test_flash_tile_straddling_shapes_match_jax_oracle(sq, skv, d, causal,
                                                       dtype):
    """The shapes chip_smoke.py runs to reach the CUDA kernel's ragged
    tiles, through ops.flash_attention on the CPU, against the JAX oracle
    (the Pallas body asserts divisibility and cannot take them)."""
    (jq, jk, jv), (q, k, v) = _attn_inputs(sq + skv + d, (1, 2, sq, d),
                                           (1, 2, skv, d), dtype)
    out = ops.flash_attention(q, k, v, causal=causal)
    assert out.shape == (1, 2, sq, d) and out.dtype == q.dtype
    _assert_close(out, jref.flash_attention_ref(jq, jk, jv, causal=causal),
                  dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [256, 512])
@pytest.mark.parametrize("causal", [True, False])
def test_pallas_body_on_the_cuda_tiles_matches_port(s, causal, dtype):
    """The TPU kernel's body in interpret mode walking the CUDA kernel's
    tiles (a 128-row q tile, the dtype's key tile) against the port's
    ops.flash_attention on the same inputs."""
    from repro.kernels.flash_attention import flash_attention as pallas_flash

    block_q, _, block_k = _cuda_tiles()
    (jq, jk, jv), (q, k, v) = _attn_inputs(s + 3, (1, 2, s, 64),
                                           (1, 2, s, 64), dtype)
    fold = lambda x: x.reshape(2, s, 64)  # noqa: E731
    expect = pallas_flash(fold(jq), fold(jk), fold(jv), causal=causal,
                          block_q=block_q, block_k=block_k[dtype],
                          interpret=True)
    out = ops.flash_attention(q, k, v, causal=causal)
    _assert_close(fold(out), expect, dtype)


def test_flash_source_is_the_hopper_design():
    """The bf16 path issues wgmma and TMA copies into an mbarrier ring; the
    fp32 path double-buffers with 16-byte cp.async and never names TF32;
    no float atomics; chip_smoke.py's key tiles are the kernel's."""
    import importlib.util
    import re
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    text = flash.LIBRARY.source.read_text()
    for needle in ("wgmma.mma_async", "cp.async.bulk.tensor",
                   "mbarrier.try_wait", "setmaxnreg", "cuTensorMapEncodeTiled",
                   "cp.async.cg.shared.global", "__grid_constant__"):
        assert needle in text, needle
    assert "tf32" not in text.lower()
    assert not re.search(r"\batomic[A-Z]\w*\(|\b(atom|red)\.", text)
    assert "-lcuda" not in " ".join(_build.NVCC_FLAGS)
    block_q, f32_block_q, block_k = _cuda_tiles()
    assert block_q == f32_block_q == 128
    assert chip_smoke.FLASH_BLOCK_K == block_k


# ---- the split decode kernel: its launch plan and its arithmetic

PLAN_BH = (1, 3, 256, 257)
PLAN_S = (1, 5, 63, 64, 65, 1000, 32768)
PLAN_SMS = (132, 114, 8)
SM_SMEM = 233_472      # shared memory of one H100 SM (228 KB)
BLOCK_RESERVED = 1024  # what the card keeps of it for each block


def _covers_once(n, tile, n_split):
    """split_range over every split covers [0, n) exactly once, in split
    order, cut on tile boundaries (n an array of walked-slot counts)."""
    at = np.zeros_like(n)
    for split in range(n_split):
        lo, hi = decode.split_range(n, tile, n_split, split)
        assert np.array_equal(lo, at), split
        assert np.all(hi >= lo) and np.all(lo % tile == 0)
        assert np.all((hi % tile == 0) | (hi == n))
        at = hi
    assert np.array_equal(at, n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", PLAN_S)
def test_decode_launch_plan_sweep(s, d, dtype):
    """The plan over (BH, S, D, dtype, SM count): n_split >= 1, shared
    memory within the H100's per-block limit and equal to the kernel's
    layout, a ring of at least 3 stages, the grid within its limit, the
    workspace the wrapper allocates of the plan's size, and the device's
    range rule covering [0, n) exactly once for every n in 1..S and for
    valid_len 0, -3 and S + 5."""
    b = dtype.itemsize
    for bh in PLAN_BH:
        for sms in PLAN_SMS:
            plan = decode._launch_plan(bh, s, d, dtype, sms)
            assert 1 <= plan.n_split <= decode.MAX_SPLIT
            assert plan.tile * d * b == decode.TILE_BYTES
            assert plan.stages >= 3
            assert plan.smem == decode._smem_bytes(plan.tile, plan.stages,
                                                   d, b)
            assert plan.smem <= decode.SMEM_LIMIT
            # the plan's blocks share an SM
            assert (decode.BLOCKS_PER_SM * (plan.smem + BLOCK_RESERVED)
                    <= SM_SMEM)
            assert plan.grid == bh * plan.n_split <= decode.GRID_LIMIT
            work = decode._workspace(plan, "cpu")
            if plan.n_split == 1:
                assert work is None and plan.workspace == 0
            else:
                assert work.dtype == torch.float32
                assert work.numel() == plan.workspace == (
                    bh * plan.n_split * (d + 2))
            ns = [decode.walked(v, s) for v in (0, -3, s + 5)]
            assert ns == [s, s, s]
            _covers_once(np.arange(1, s + 1), plan.tile, plan.n_split)


def test_decode_launch_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="head dim"):
        decode._launch_plan(4, 64, 96, torch.float32, 132)
    with pytest.raises(TypeError, match="dtype"):
        decode._launch_plan(4, 64, 64, torch.float16, 132)
    with pytest.raises(ValueError, match="empty"):
        decode._launch_plan(0, 64, 64, torch.float32, 132)
    with pytest.raises(ValueError, match="exceed"):
        decode._launch_plan(2**30, 1 << 20, 64, torch.float32, 2**30)


def _split_decode_emulation(q, k, v, valid, tile, n_split):
    """The kernel's arithmetic in plain torch, test-only: each split folds
    its tiles (split_range) in order with an online softmax (max,
    normaliser, accumulator in fp32; p rounded to the cache's dtype before
    PV), an empty split leaves (-1e30, 0, 0), and the partials merge in
    split order into acc / max(l, 1e-30) in q's dtype."""
    bh, s, d = k.shape
    n = decode.walked(valid, s)
    parts = []
    for split in range(n_split):
        lo, hi = (int(x) for x in decode.split_range(n, tile, n_split, split))
        m = torch.full((bh,), -1e30)
        l, acc = torch.zeros(bh), torch.zeros(bh, d)
        for t0 in range(lo, hi, tile):
            kt, vt = k[:, t0:min(t0 + tile, hi)], v[:, t0:min(t0 + tile, hi)]
            sc = torch.einsum("bd,btd->bt", q.float(), kt.float()) / np.sqrt(d)
            if valid < 1:
                sc = torch.full_like(sc, -1e30)
            mx = torch.maximum(m, sc.amax(dim=1))
            corr = torch.exp(m - mx)
            p = torch.exp(sc - mx[:, None])
            l = l * corr + p.sum(dim=1)
            acc = acc * corr[:, None] + torch.einsum(
                "bt,btd->bd", p.to(q.dtype).float(), vt.float())
            m = mx
        parts.append((m, l, acc))
    big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    lsum, out = torch.zeros(bh), torch.zeros(bh, d)
    for m, l, acc in parts:
        f = torch.exp(m - big)
        lsum = lsum + l * f
        out = out + acc * f[:, None]
    return (out / lsum.clamp_min(1e-30)[:, None]).to(q.dtype)


# (tile, n_split) on a 1000-slot cache: small ones, and the plan at BH 3,
# D 64 bf16 on an H100
SPLIT_CONFIGS = [(16, 4), (64, 5), "plan"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("config", SPLIT_CONFIGS, ids=str)
@pytest.mark.parametrize("case", ["zero", "one", "fewer_than_splits",
                                  "tile-1", "tile+1", "splits*tile-1",
                                  "splits*tile+1", "full", "past_end"])
def test_decode_split_emulation_matches_jax(case, config, dtype):
    """Split partials and the fixed-order merge, emulated in plain torch,
    against the JAX oracle and the Pallas body in interpret mode, at
    valid_len straddling the tile and the splits, 0 (the mean of v) and
    past S; and the package's plain version (the oracle on the card)."""
    b, h, s, d = 1, 3, 1000, 64
    tile, n_split = config if config != "plan" else (
        lambda p: (p.tile, p.n_split))(decode._launch_plan(
            b * h, s, d, torch.bfloat16, 132))
    assert n_split > 1
    valid = {"zero": 0, "one": 1, "fewer_than_splits": n_split - 1,
             "tile-1": tile - 1, "tile+1": tile + 1,
             "splits*tile-1": n_split * tile - 1,
             "splits*tile+1": n_split * tile + 1, "full": s,
             "past_end": s + 5}[case]
    (jq, jk, jv), (q, k, v) = _attn_inputs(valid + tile + 31, (b, h, d),
                                           (b, h, s, d), dtype)
    out = _split_decode_emulation(q.reshape(b * h, d),
                                  k.reshape(b * h, s, d),
                                  v.reshape(b * h, s, d), valid, tile,
                                  n_split).reshape(b, h, d)
    _assert_close(out, jref.decode_attention_ref(jq, jk, jv, valid), dtype)
    _assert_close(out, jops.decode_attention(jq, jk, jv, jnp.asarray(valid),
                                             interpret=True), dtype)
    _assert_close(out, ops.decode_attention(q, k, v, valid).float().numpy(),
                  dtype)


def test_decode_source_is_the_split_design():
    """The kernel streams K and V with 1-D bulk async copies into an
    mbarrier ring and merges its splits in a second pass; no float
    atomics, no TF32; its constants and shared-memory layout are the
    plan's; chip_smoke.py's decode constants agree with the plan, whose
    main-path launch splits each bh's cache."""
    import importlib.util
    import re
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    text = decode.LIBRARY.source.read_text()
    for needle in ("cp.async.bulk.shared::cluster.global.mbarrier",
                   "mbarrier.try_wait", "mbarrier.arrive.expect_tx",
                   "merge_kernel", "fence.mbarrier_init"):
        assert needle in text, needle
    assert "tf32" not in text.lower()
    assert not re.search(r"\batomic[A-Z]\w*\(|\b(atom|red)\.", text)
    const = {name: int(val) for name, val in
             re.findall(r"constexpr int (k\w+) = (\d+);", text)}
    assert const["kConsumers"] == decode.CONSUMERS
    assert const["kMaxStages"] >= decode.STAGES
    assert const["kSmemLimit"] == decode.SMEM_LIMIT
    assert const["kMaxSplit"] >= decode.MAX_SPLIT
    assert "return 2 * stages * tile * d * b + kStates * (d + 2) * 4 + " \
        "2 * stages * 8;" in text
    assert const["kTileBytes"] == decode.TILE_BYTES
    sms = chip_smoke.H100_SMS
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        for d in decode.HEAD_DIMS:
            main = decode._launch_plan(1, 1, d, dtype, sms)
            assert chip_smoke.DECODE_TILE[name][d] == main.tile
        for bh, s, d in chip_smoke.DECODE_STRADDLE:
            plan = decode._launch_plan(bh, s, d, dtype, sms)
            assert s % plan.tile and plan.n_split * plan.tile + 1 <= s
    db, h = chip_smoke.DECODE["batch"], chip_smoke.QWEN3_4B["num_heads"]
    main = decode._launch_plan(db * h, chip_smoke.DECODE["cache"],
                               chip_smoke.QWEN3_4B["head_dim"],
                               torch.bfloat16, sms)
    assert main.n_split > 1

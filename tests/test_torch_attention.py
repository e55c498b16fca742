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

"""LM training in the port (the flash backward, the CE's backward,
`loss_fn`'s gradient under remat, the optimizer twins) against the JAX
package's, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages; the
reference's weights are carried across with `lm.params_from_reference`.
On the CPU the flash route's backward is the kernel's plain version
(`flash_attention_bwd_plain`), reached through the same autograd Function
(`ops._FlashAttention`) that launches the CUDA kernel on the card, where
chip_smoke.py (phase 17) holds the kernel against that plain version and
a float64 evaluation.

Tolerances (each test states its own):
  - the plain backward and lse against the reference's `_flash_fwd` /
    `_flash_bwd`: fp32 rtol 1e-5 / atol 1e-5 of the largest |value|; bf16
    2^-7 of the largest |value| (both round the scores and dout V^T to
    bf16 in the same places; they differ by a bf16 ulp where the fp32
    sums below round apart);
  - the attention gradient: rtol = atol = 1e-3, the reference's own test
    of its custom VJP (tests/test_kernels.py:225);
  - the CE gradient: fp32 rtol 1e-6 / atol 1e-7; bf16 one bf16 ulp of
    the largest |value|;
  - `loss_fn`'s gradients, fp32: each leaf's largest |port - ref| at most
    (F32_GRAD_NOISE x the model's conditioning + F32_GRAD_FLOOR) of the
    leaf's largest |value|. The conditioning is the largest relative
    change of any leaf's gradient in the reference itself when every
    weight moves by one ulp (two draws): the smoke init's fan_in = L
    weights put attention near an argmax, so it is ~1e-6 for qwen3-4b
    (qk-norm) and ~1e-3 for whisper, where the two packages' fp32
    gradients differ by as much as the reference's own differ from a
    float64 evaluation. The floor is tests/test_torch_lm.py's
    MODEL_F32_TOL (2e-5). bf16: each leaf's
    mean error against the reference's fp32 gradient (the same bf16
    weights) at most 3 times the reference's own bf16 run's (the ratio
    measured over the ten archs is 0.9-2.0), the forward tests' rule for
    bf16;
  - remat against no remat: bit for bit;
  - 3 training steps: losses within 1e-5 of each other (relative).
"""

import dataclasses
import functools
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.gnn import models as gnn_models  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402

ARCHS = tbase.ARCH_IDS
B, S = 2, 32
F32_GRAD_FLOOR = 2e-5
F32_GRAD_NOISE = 4.0
BF16_GRAD_RATIO = 3.0
STEP_LOSS_RTOL = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(arr, dtype):
    """One float32 NumPy array as a JAX array and a torch tensor of
    `dtype` (the same round-to-nearest-even to bf16 on both sides)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(arr, jdt), torch.as_tensor(arr).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


def _leaves(prefix, tree) -> dict:
    """{prefix/path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(f"{prefix}/{k}", v))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# the flash backward's plain version and the autograd Function
# ---------------------------------------------------------------------------

# (sq, skv, d, causal, block_q, block_k): the reference's blocks divide its
# shapes; Skv 1000 is ragged against every tile of the backward kernel's
# (64 and 128 rows or keys)
FLASH_CASES = [(256, 256, 64, True, 64, 128), (256, 256, 128, False, 128, 64),
               (128, 128, 128, True, 128, 128), (200, 1000, 64, False, 100, 250)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,d,causal,block_q,block_k", FLASH_CASES)
def test_plain_backward_and_lse_match_the_reference(sq, skv, d, causal,
                                                    block_q, block_k, dtype):
    """`flash_attention_plain(return_lse=True)` and
    `flash_attention_bwd_plain` against the reference's blockwise
    `_flash_fwd` / `_flash_bwd` called directly (B 1, H 3)."""
    rng = np.random.default_rng(sq + skv + d)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((1, 3, sq, d), (1, 3, skv, d), (1, 3, skv, d),
                      (1, 3, sq, d))]
    (jq, q), (jk, k), (jv, v), (jdo, dout) = [_both(a, dtype) for a in arrs]
    static = (causal, 0, block_q, block_k, 1.0 / float(np.sqrt(d)))
    jout, res = jlayers._flash_fwd(static, jq, jk, jv)
    jdq, jdk, jdv = jlayers._flash_bwd(static, res, jdo)

    fold = lambda x: x.reshape(3, x.shape[2], d)  # noqa: E731
    out, lse = flash.flash_attention_plain(fold(q), fold(k), fold(v),
                                           causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (3, sq)
    np.testing.assert_allclose(lse.numpy(), _f32(res[4]).reshape(3, sq),
                               rtol=1e-5, atol=1e-5)
    # the backward from the reference's own residuals, so only the
    # backward's arithmetic is compared
    got = flash.flash_attention_bwd_plain(
        fold(q), fold(k), fold(v),
        fold(torch.as_tensor(_f32(res[3])).to(q.dtype)),
        torch.as_tensor(_f32(res[4])).reshape(3, sq), fold(dout),
        causal=causal)
    for name, g, want in zip(("dq", "dk", "dv"), got, (jdq, jdk, jdv)):
        assert g.dtype == q.dtype, name
        want = _f32(want).reshape(g.shape)
        scale = float(np.abs(want).max())
        if dtype == "float32":
            tol = dict(rtol=1e-5, atol=1e-5 * scale)
        else:
            tol = dict(rtol=0, atol=2.0 ** -7 * scale)
        np.testing.assert_allclose(_f32(g), want, err_msg=name, **tol)
    np.testing.assert_allclose(_f32(out), _f32(jout).reshape(out.shape),
                               rtol=1e-5 if dtype == "float32" else 2e-2,
                               atol=1e-5 if dtype == "float32" else 2e-2)


@pytest.fixture
def flash_route(monkeypatch):
    """`layers.attention` routing as on the card, the flash route taking
    `ops.flash_attention` on its CPU path (the plain versions inside the
    autograd Function); counts the plain backward's calls."""
    calls = []
    real_route, real_flash = layers.attention_route, ops.flash_attention
    real_bwd = flash.flash_attention_bwd_plain

    def route(*args, device="cuda", **kw):
        return real_route(*args, device="cuda", **kw)

    def flash_cpu(q, k, v, *, causal, use_pallas, window=0):
        assert use_pallas is True
        return real_flash(q, k, v, causal=causal, window=window,
                          use_pallas=None)

    def bwd(*args, **kw):
        calls.append(args[0].shape)
        return real_bwd(*args, **kw)

    monkeypatch.setattr(layers, "attention_route", route)
    monkeypatch.setattr(layers.ops, "flash_attention", flash_cpu)
    monkeypatch.setattr(flash, "flash_attention_bwd_plain", bwd)
    return calls


@pytest.mark.parametrize("hq,hkv", [(2, 2), (4, 2)])
def test_attention_gradient_matches_the_reference_custom_vjp(flash_route,
                                                             hq, hkv):
    """The port's `layers.attention` on the flash route (B 1, S 2048, D
    64, fp32; GQA with 2 KV heads repeated) against the reference's
    `layers.attention`, whose blockwise custom VJP takes this shape; the
    gradients of sum(out^2), rtol = atol = 1e-3 (tests/test_kernels.py:225)."""
    rng = np.random.default_rng(hq)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((1, hq, 2048, 64), (1, hkv, 2048, 64),
                      (1, hkv, 2048, 64))]
    jargs = [jnp.asarray(a) for a in arrs]
    targs = [torch.as_tensor(a).requires_grad_() for a in arrs]
    want = jax.grad(lambda q, k, v: (jlayers.attention(
        q, k, v, causal=True, block_q=256, block_k=512) ** 2).sum(),
        argnums=(0, 1, 2))(*jargs)
    out = layers.attention(*targs, causal=True)
    got = torch.autograd.grad((out ** 2).sum(), targs)
    assert flash_route == [(hq, 2048, 64)]
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-3, atol=1e-3,
                                   err_msg=name)


def test_flash_function_only_with_a_gradient_and_kernels_raise_on_cpu():
    """`ops.flash_attention` takes the Function only when a gradient is
    wanted (its output then has a grad_fn), returns the same values
    either way, and the kernel wrappers refuse CPU tensors (nothing falls
    back)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 2, 40, 64))
                               .astype(np.float32)) for _ in range(3))
    plain = ops.flash_attention(q, k, v)
    assert plain.grad_fn is None
    qg = q.clone().requires_grad_()
    out = ops.flash_attention(qg, k, v)
    assert out.grad_fn is not None and torch.equal(out.detach(), plain)
    with torch.no_grad():
        assert ops.flash_attention(qg, k, v).grad_fn is None
    fold = lambda x: x.reshape(2, 40, 64)  # noqa: E731
    lse = torch.zeros(2, 40)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention_bwd(fold(q), fold(k), fold(v), fold(q), lse,
                                  fold(q))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention(fold(q), fold(k), fold(v), return_lse=True)
    with pytest.raises(ValueError, match="lse"):
        flash.flash_attention_bwd(fold(q), fold(k), fold(v), fold(q),
                                  torch.zeros(2, 39), fold(q))
    with pytest.raises(ValueError, match="use_pallas=True"):
        ops.flash_attention(qg, k, v, use_pallas=True)


def test_function_pairs_the_kernels_when_the_kernel_route_is_taken(
        monkeypatch):
    """With the kernel route taken (as on a CUDA tensor), the Function's
    forward calls the forward kernel's wrapper with the lse output and its
    backward the backward kernel's wrapper, never the plain backward: the
    wrappers stand in here as recorders over the plain versions."""
    calls = []
    plain_fwd, plain_bwd = (flash.flash_attention_plain,
                            flash.flash_attention_bwd_plain)

    def fwd(q, k, v, *, causal, window=0, return_lse=False):
        calls.append(("fwd", return_lse))
        return plain_fwd(q, k, v, causal=causal, window=window,
                         return_lse=return_lse)

    def bwd(*args, causal, window=0):
        calls.append(("bwd", causal))
        return plain_bwd(*args, causal=causal, window=window)

    def no_plain_bwd(*args, **kw):
        raise AssertionError("the plain backward ran on the kernel route")

    monkeypatch.setattr(ops, "_use_kernel", lambda x, use_pallas: True)
    monkeypatch.setattr(flash, "flash_attention", fwd)
    monkeypatch.setattr(flash, "flash_attention_bwd", bwd)
    monkeypatch.setattr(flash, "flash_attention_bwd_plain", no_plain_bwd)
    rng = np.random.default_rng(1)
    q, k, v = (torch.as_tensor(rng.normal(size=(1, 2, 24, 64))
                               .astype(np.float32)).requires_grad_()
               for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=False)
    torch.autograd.grad(out.sum(), (q, k, v))
    assert calls == [("fwd", True), ("bwd", False)]


def test_backward_source_is_built_at_first_use_without_float_atomics(
        monkeypatch, tmp_path):
    """The backward's CUDA source ships in the package with a plain C
    entry point for sm_90a; importing and a CPU gradient build nothing
    and launch nothing; building without nvcc raises; no float atomics
    (each output has one writer, so runs repeat bit for bit)."""
    text = flash.BWD_LIBRARY.source.read_text()
    assert 'extern "C"' in text and "sm_90a" in text
    assert "flash_attention_bwd_error_string" in text
    assert not re.search(r"\batomic\w*\s*\(", text)
    assert re.search(r"lse != nullptr", flash.LIBRARY.source.read_text())
    before = (dict(flash.LAUNCHES), dict(flash.BWD_LAUNCHES))
    q = torch.zeros(1, 2, 8, 64, requires_grad=True)
    ops.flash_attention(q, q, q).sum().backward()
    assert flash.BWD_LIBRARY._lib is None
    assert (dict(flash.LAUNCHES), dict(flash.BWD_LAUNCHES)) == before
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        flash.BWD_LIBRARY.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all([flash.BWD_LIBRARY])


def _bwd_tiles() -> dict:
    """The backward kernel's tiles by name, bf16 (kBfDkvBlockK,
    kBfDkvBlockQ, kBfDqBlockQ, kBfDqBlockK) and fp32 (kF32...), read from
    its source."""
    text = flash.BWD_LIBRARY.source.read_text()
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (k(?:Bf|F32)\w+Block[QK]) = (\d+);", text)}


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# Sq = Skv one short of and one past the kernels' 32-row (fp32), 64-row
# (bf16) and 128-row (or key) tiles, and one past two 128 tiles; a full
# call whose Skv is no multiple of any tile
BWD_STRADDLE_SIZES = (31, 33, 63, 65, 127, 129, 257)
BWD_STRADDLE = [(s, s, d, causal) for s in BWD_STRADDLE_SIZES
                for d in (64, 128) for causal in (True, False)] + [
                    (200, 1000, 64, False), (200, 1000, 128, False)]


def test_backward_source_is_the_hopper_design():
    """The backward's source keeps its plain C entry point for sm_90a and
    no float atomics; its bf16 path issues wgmma on TMA copies, its fp32
    path 3xTF32 mma.sync (operands split in registers, big rounded to
    tf32 to nearest) on TMA copies of fp32 tiles, the old FMA kernels
    gone; the straddling sizes below and chip_smoke.py's are one short of
    and one past each of its tiles, bf16 and fp32."""
    text = flash.BWD_LIBRARY.source.read_text()
    for needle in ('extern "C"', "sm_90a", "wgmma.mma_async",
                   "cp.async.bulk.tensor", "mbarrier.try_wait", "setmaxnreg",
                   "cuTensorMapEncodeTiled", "__grid_constant__"):
        assert needle in text, needle
    assert not re.search(r"\batomic\w*\s*\(", text)
    fp32 = text[text.index("-" * 66 + " fp32"):]
    for needle in ("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
                   ".tf32", "CU_TENSOR_MAP_DATA_TYPE_FLOAT32",
                   "tma_load_3d", "setmaxnreg", "dkdv_f32_kernel",
                   "dq_f32_kernel", "launch_f32"):
        assert needle in fp32, needle
    # the split: big = x rounded to tf32 (half a tf32 ulp, 13 bits
    # cleared), small = x - big
    assert re.search(r"\+ 0x1000u\) & 0xffffe000u", fp32)
    assert re.search(r"x\[i\] - __uint_as_float\(s\.big\[i\]\)", fp32)
    assert not re.search(r"\b(dkdv|dq)_kernel\b", text)  # the FMA kernels
    tiles = _bwd_tiles()
    assert set(tiles) == {f"k{p}{k}Block{a}" for p in ("Bf", "F32")
                          for k, a in (("Dkv", "K"), ("Dkv", "Q"),
                                       ("Dq", "Q"), ("Dq", "K"))}
    edges = {t + o for t in tiles.values() for o in (-1, 1)}
    assert sorted(edges | {2 * max(tiles.values()) + 1}) == list(
        BWD_STRADDLE_SIZES)
    assert _chip_smoke().FLASH_BWD_STRADDLE == BWD_STRADDLE


@pytest.mark.parametrize("dtype,bh,s,d,ms", [
    ("float32", 32, 4096, 128, 2.083),   # row 3: 3 TF32 passes
    ("float32", 100, 2048, 64, 0.814),   # hymba
    ("bfloat16", 64, 2048, 128, 0.174),  # the qwen3-4b step
])
def test_backward_bound_counts_three_tf32_passes_for_fp32(dtype, bh, s, d,
                                                          ms):
    """chip_smoke.py's bound of the causal backward: the five products on
    the tensor cores, bf16 at 989 TFLOP/s, fp32 as three TF32 passes at
    495 TFLOP/s (the fp32 kernel's 3xTF32), bound by operations."""
    bound, by = _chip_smoke()._bwd_bound(dtype, bh, s, s, d, True)
    assert round(bound, 3) == ms and by == "operations"


def _oracle_grads(arrs, causal, dtype):
    """jax.grad of sum(out^2) through the reference oracle, out in fp32."""
    from repro.kernels import ref as jref

    def loss(q, k, v):
        out = jref.flash_attention_ref(q, k, v, causal=causal)
        return (out.astype(jnp.float32) ** 2).sum()

    args = [jnp.asarray(a, dtype) for a in arrs]
    return [_f32(g) for g in jax.grad(loss, argnums=(0, 1, 2))(*args)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,d,causal", BWD_STRADDLE)
def test_backward_at_the_tile_edges_matches_jax_grad(sq, skv, d, causal,
                                                     dtype):
    """The shapes that reach the kernels' ragged tiles on the card
    (chip_smoke.py holds the kernel there), through `ops.flash_attention`'s
    autograd Function on the CPU (the plain forward and backward), against
    jax.grad of the reference oracle (B 1, H 2; the gradients of sum(out^2)).
    fp32: rtol = atol = 1e-3, the reference's own custom-VJP test
    (tests/test_kernels.py:225). bf16: each gradient's mean error against
    the oracle's fp32 gradient (the same bf16 inputs) at most
    BF16_GRAD_RATIO times the oracle's own bf16 gradient's."""
    rng = np.random.default_rng(sq + skv + d + int(causal))
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((1, 2, sq, d), (1, 2, skv, d), (1, 2, skv, d))]
    tdt = DTYPES[dtype][1]
    targs = [torch.as_tensor(a).to(tdt).requires_grad_() for a in arrs]
    out = ops.flash_attention(*targs, causal=causal)
    assert out.grad_fn is not None
    got = [_f32(g) for g in torch.autograd.grad(
        (out.float() ** 2).sum(), targs)]
    if dtype == "float32":
        for name, g, w in zip("qkv", got, _oracle_grads(arrs, causal,
                                                        jnp.float32)):
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3,
                                       err_msg=name)
        return
    rounded = [_f32(t.detach()) for t in targs]
    truth = _oracle_grads(rounded, causal, jnp.float32)
    own = _oracle_grads(rounded, causal, jnp.bfloat16)
    for name, g, t, o in zip("qkv", got, truth, own):
        err, ref_err = np.abs(g - t).mean(), np.abs(o - t).mean()
        assert err <= BF16_GRAD_RATIO * ref_err, (name, err, ref_err)


# ---------------------------------------------------------------------------
# the CE's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_xent_gradient_matches_the_reference(dtype):
    """`lm._softmax_xent` value and gradient (g random per token) against
    `jax.vjp` of the reference's custom-VJP `_softmax_xent`."""
    rng = np.random.default_rng(4)
    logits = (3 * rng.normal(size=(2, 7, 300))).astype(np.float32)
    targets = rng.integers(0, 300, (2, 7)).astype(np.int32)
    g = rng.normal(size=(2, 7)).astype(np.float32)
    jl, tl = _both(logits, dtype)
    nll, vjp = jax.vjp(lambda x: jlm._softmax_xent(x, jnp.asarray(targets)),
                       jl)
    (want,) = vjp(jnp.asarray(g))
    tl.requires_grad_()
    got_nll = lm._softmax_xent(tl, torch.as_tensor(targets))
    (got,) = torch.autograd.grad(got_nll, tl, torch.as_tensor(g))
    assert got.dtype == tl.dtype
    np.testing.assert_allclose(_f32(got_nll), _f32(nll), rtol=1e-6,
                               atol=1e-6)
    if dtype == "float32":
        tol = dict(rtol=1e-6, atol=1e-7)
    else:
        tol = dict(rtol=0, atol=2.0 ** -8 * float(np.abs(_f32(want)).max()))
    np.testing.assert_allclose(_f32(got), _f32(want), **tol)


# ---------------------------------------------------------------------------
# loss_fn's gradient, every arch
# ---------------------------------------------------------------------------


def _batch(cfg, tokens, dtype):
    """The training batch of `tokens` with the family's extras (whisper's
    frames, the VLM's patch embeddings and M-RoPE positions), as (JAX,
    torch)."""
    rng = np.random.default_rng(3)
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.as_tensor(tokens)}
    b, t = tokens.shape
    if cfg.encoder_decoder:
        f = rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
        jb["frames"], tb["frames"] = _both(f.astype(np.float32), dtype)
    if cfg.family == "vlm":
        f = rng.normal(size=(b, cfg.num_patches, cfg.d_model))
        jb["patch_embeds"], tb["patch_embeds"] = _both(f.astype(np.float32),
                                                       dtype)
        total = cfg.num_patches + t
        pos3 = np.broadcast_to(np.arange(total, dtype=np.int32)[None, None],
                               (3, b, total)).copy()
        jb["pos3"], tb["pos3"] = jnp.asarray(pos3), torch.as_tensor(pos3)
    return jb, tb


def _configs(arch, dtype):
    return (dataclasses.replace(jbase.smoke_config(arch), dtype=dtype),
            dataclasses.replace(tbase.smoke_config(arch), dtype=dtype))


def _one_ulp(tree, seed):
    """Every float32 weight moved by one ulp, up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        to = np.where(rng.random(a.shape) < 0.5, np.inf, -np.inf)
        return jnp.asarray(np.nextafter(a, to.astype(np.float32)))

    return jax.tree.map(move, tree)


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's weights (bf16 init, and cast to fp32), the tokens,
    its gradients of `loss_fn(remat=False)` at fp32 and bf16 ({path:
    float32 array}), and the fp32 gradients' conditioning: the largest
    relative change of a leaf when the weights move by one ulp (two
    draws)."""
    jc16, _ = _configs(arch, "bfloat16")
    jc32, _ = _configs(arch, "float32")
    p16 = jax.jit(functools.partial(jlm.init_params, jc16))(
        jax.random.PRNGKey(7))
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p16)
    tokens = np.random.default_rng(len(arch)).integers(
        0, jc32.vocab_size, (B, S)).astype(np.int32)
    out = {"tokens": tokens, "params": {
        "bfloat16": jax.tree.map(np.asarray, p16),
        "float32": jax.tree.map(np.asarray, p32)}}
    for dtype, jc, params in (("float32", jc32, p32),
                              ("bfloat16", jc16, p16)):
        jb, _ = _batch(jc, tokens, dtype)
        vg = jax.jit(jax.value_and_grad(
            lambda p, b, c=jc: jlm.loss_fn(c, p, b, remat=False)))
        loss, grads = vg(params, jb)
        out[dtype] = {"loss": float(loss),
                      "grads": {k: _f32(v) for k, v in
                                _leaves("", grads).items()}}
        if dtype == "float32":
            cond = 0.0
            for seed in (5, 6):
                _, moved = vg(_one_ulp(params, seed), jb)
                for k, v in _leaves("", moved).items():
                    w = out[dtype]["grads"][k]
                    scale = max(float(np.abs(w).max()), 1e-30)
                    cond = max(cond, float(np.abs(_f32(v) - w).max()) / scale)
            out["float32 conditioning"] = cond
    return out


def _grads(cfg, params, batch, remat):
    """(loss, {path: gradient}) of the port's `loss_fn`; weights that take
    no part get zeros, as `jax.grad` gives them (hymba's `ln_ssm`)."""
    live = optim.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = lm.loss_fn(cfg, live, batch, remat=remat)
    grads = iter(torch.autograd.grad(loss, optim.leaves(live),
                                     materialize_grads=True))
    return loss.detach(), _leaves("", optim.tree_map(lambda _: next(grads),
                                                     live))


@functools.lru_cache(maxsize=None)
def _port(arch, dtype, remat):
    ref = _reference(arch)
    _, tc = _configs(arch, dtype)
    _, tb = _batch(tc, ref["tokens"], dtype)
    return _grads(tc, lm.params_from_reference(ref["params"][dtype]), tb,
                  remat)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_fp32(arch):
    """`loss_fn(remat=True)`'s value and every leaf's gradient at fp32
    against `jax.grad` of the reference's `loss_fn(remat=False)`, the
    weights carried across: each leaf within (F32_GRAD_NOISE x the
    reference's conditioning + F32_GRAD_FLOOR) of its scale."""
    ref = _reference(arch)
    loss, got = _port(arch, "float32", True)
    np.testing.assert_allclose(float(loss), ref["float32"]["loss"],
                               rtol=2e-5)
    want = ref["float32"]["grads"]
    rel = F32_GRAD_NOISE * ref["float32 conditioning"] + F32_GRAD_FLOOR
    assert set(got) == set(want)
    for name, w in want.items():
        g = _f32(got[name])
        assert g.shape == w.shape, name
        bound = rel * float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{arch} {name}: {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_gradients_match_jax_bf16(arch):
    """At bf16 (the reference's init): each leaf's mean error against the
    reference's fp32 gradient of the same weights at most BF16_GRAD_RATIO
    times the reference's own bf16 gradient's, and the loss within 0.1
    (tests/test_torch_lm.py's MODEL_BF16_TOL)."""
    ref = _reference(arch)
    loss, got = _port(arch, "bfloat16", True)
    np.testing.assert_allclose(float(loss), ref["bfloat16"]["loss"],
                               rtol=0.1, atol=0.1)
    truth = ref["float32"]["grads"]
    for name, r16 in ref["bfloat16"]["grads"].items():
        g = _f32(got[name])
        own = float(np.abs(r16 - truth[name]).mean())
        err = float(np.abs(g - truth[name]).mean())
        assert err <= BF16_GRAD_RATIO * own + 1e-30, (
            f"{arch} {name}: mean err {err:.3g} > {BF16_GRAD_RATIO} x "
            f"{own:.3g}")


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_equal_no_remat_bitwise(arch):
    """`remat=True` (each block recomputed in the backward) gives the
    gradients of `remat=False` bit for bit, fp32 and bf16."""
    for dtype in ("float32", "bfloat16"):
        loss_r, with_remat = _port(arch, dtype, True)
        loss_n, without = _port(arch, dtype, False)
        assert torch.equal(loss_r, loss_n)
        for name, g in with_remat.items():
            assert torch.equal(g, without[name]), f"{arch} {dtype} {name}"


def test_remat_policy_hook():
    """`set_remat_policy` accepts the reference's "ssm_proj" and any other
    name, as the reference's stores any; None, the reference's full
    recompute, restores the plain path (tests/test_torch_remat_policy.py
    holds the policy's gradients)."""
    arch = "mamba2-370m"
    ref = _reference(arch)
    _, tc = _configs(arch, "float32")
    _, tb = _batch(tc, ref["tokens"], "float32")
    params = lm.params_from_reference(ref["params"]["float32"])
    loss_n, without = _port(arch, "float32", True)  # under None
    try:
        for name in ("ssm_proj", "no_such_tag"):
            lm.set_remat_policy(name)
            assert lm._REMAT_POLICY == name
            loss, got = _grads(tc, params, tb, True)
            assert torch.equal(loss, loss_n)
            assert all(torch.equal(g, without[k]) for k, g in got.items())
    finally:
        lm.set_remat_policy(None)
    assert lm._REMAT_POLICY is None


# ---------------------------------------------------------------------------
# the optimizer twins and the step
# ---------------------------------------------------------------------------


def _lm_tree(seed):
    """An LM-shaped nested dict of float32 NumPy arrays (qwen3-4b's smoke
    init tree), and random gradients of its shapes."""
    jc, _ = _configs("qwen3-4b", "float32")
    shapes = jax.eval_shape(functools.partial(jlm.init_params, jc),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    draw = lambda s: rng.normal(size=s.shape).astype(np.float32)  # noqa: E731
    return jax.tree.map(draw, shapes), jax.tree.map(draw, shapes)


def _tensors(tree):
    return optim.tree_map(torch.as_tensor, tree)


def _hold_tree(port, ref, **tol):
    want = _leaves("", jax.tree.map(_f32, ref))
    got = _leaves("", port)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(_f32(got[name]), w, err_msg=name, **tol)


def test_adam_on_an_lm_tree_matches_the_reference():
    """`adam_init` / `adam_update` walk a nested dict: 3 steps on an LM
    tree, every leaf against `repro.optim.adam_update` (rtol 1e-6)."""
    params_np, grads_np = _lm_tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params_np), _tensors(params_np)
    js, ts = joptim.adam_init(jp), optim.adam_init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a, s=step: a * (s + 1), grads_np)
        jp, js = joptim.adam_update(jax.tree.map(jnp.asarray, g), js, jp,
                                    lr=3e-4)
        tp, ts = optim.adam_update(_tensors(g), ts, tp, lr=3e-4)
    _hold_tree(tp, jp, rtol=1e-6, atol=1e-7)
    _hold_tree(ts.mu, js.mu, rtol=1e-6, atol=1e-7)
    _hold_tree(ts.nu, js.nu, rtol=1e-6, atol=1e-7)
    assert int(ts.step) == int(js.step) == 3


def test_sgd_and_clip_match_the_reference():
    """`sgd_init` / `sgd_update` (3 steps) and `clip_by_global_norm`
    (clipping and not) on an LM tree against the reference's (rtol 1e-6;
    the norm sums the leaves in another order)."""
    params_np, grads_np = _lm_tree(1)
    jp, tp = jax.tree.map(jnp.asarray, params_np), _tensors(params_np)
    js, ts = joptim.sgd_init(jp), optim.sgd_init(tp)
    for step in range(3):
        g = jax.tree.map(lambda a, s=step: a / (s + 1), grads_np)
        jp, js = joptim.sgd_update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = optim.sgd_update(_tensors(g), ts, tp)
    _hold_tree(tp, jp, rtol=1e-6, atol=1e-7)
    _hold_tree(ts.velocity, js.velocity, rtol=1e-6, atol=1e-7)
    for max_norm in (1.0, 1e6):
        jc, jn = joptim.clip_by_global_norm(
            jax.tree.map(jnp.asarray, grads_np), max_norm)
        tc, tn = optim.clip_by_global_norm(_tensors(grads_np), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _hold_tree(tc, jc, rtol=1e-6, atol=1e-9)
    # a bf16 leaf keeps its dtype, scaled in fp32 and rounded once
    bf = {"w": torch.tensor([3.0, 4.0], dtype=torch.bfloat16)}
    clipped, norm = optim.clip_by_global_norm(bf, 1.0)
    assert clipped["w"].dtype == torch.bfloat16 and float(norm) == 5.0
    assert clipped["w"].tolist() == [0.6015625, 0.80078125]


def test_tree_walk_keeps_the_gnn_tree_and_its_order():
    """The GNN's `{"layers": [{name: tensor}]}` tree walks as before the
    walk took any tree: leaves layer by layer in each layer's name order,
    `tree_map` rebuilding the same structure, and an Adam step equal bit
    for bit to the formula applied leaf by leaf; tuples are leaves."""
    spec = gnn_models.GNNSpec(model="gat", feature_dim=16, hidden_dim=8,
                              num_classes=5, num_layers=3)
    params = gnn_models.init_params(spec, seed=0, device="cpu")
    flat = [t for layer in params["layers"] for t in layer.values()]
    assert all(a is b for a, b in zip(optim.leaves(params), flat))
    assert len(optim.leaves(params)) == len(flat)
    same = optim.tree_map(lambda t: t, params)
    assert [list(layer) for layer in same["layers"]] == [
        list(layer) for layer in params["layers"]]
    pairs = optim.tree_map(lambda t: (t, t), params)
    assert isinstance(pairs["layers"][0]["w"], tuple)
    grads = optim.tree_map(lambda t: torch.full_like(t, 0.5), params)
    new, state = optim.adam_update(grads, optim.adam_init(params), params,
                                   lr=1e-3)
    c1 = 1.0 - 0.9 ** torch.tensor(1.0)
    c2 = 1.0 - 0.999 ** torch.tensor(1.0)
    for p, g, n in zip(flat, optim.leaves(grads), optim.leaves(new)):
        m = 0.9 * torch.zeros_like(p) + (1.0 - 0.9) * g
        v = 0.999 * torch.zeros_like(p) + (1.0 - 0.999) * torch.square(g)
        delta = (m / c1) / (torch.sqrt(v / c2) + 1e-8)
        assert torch.equal(n, p - 1e-3 * delta)


def _jax_step(jc, jb):
    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(
            lambda p: jlm.loss_fn(jc, p, jb, remat=True))(params)
        grads, norm = joptim.clip_by_global_norm(grads, 1.0)
        params, state = joptim.adam_update(grads, state, params, lr=3e-4)
        return loss, norm, params, state
    return step


def test_three_training_steps_match_the_reference():
    """loss -> gradient -> clip_by_global_norm(1.0) -> adam_update(lr
    3e-4), the reference's train.py defaults, 3 steps of qwen3-4b's smoke
    config at fp32 in both packages: every loss within STEP_LOSS_RTOL, the
    loss falling, the gradient norms within 1e-4."""
    arch = "qwen3-4b"
    ref = _reference(arch)
    jc, tc = _configs(arch, "float32")
    jb, tb = _batch(jc, ref["tokens"], "float32")
    jp = jax.tree.map(jnp.asarray, ref["params"]["float32"])
    js = joptim.adam_init(jp)
    tp = lm.params_from_reference(ref["params"]["float32"])
    ts = optim.adam_init(tp)
    step = _jax_step(jc, jb)
    losses = []
    for _ in range(3):
        jl, jnorm, jp, js = step(jp, js)
        loss, grads = _grads(tc, tp, tb, True)
        flat = iter(grads.values())
        clipped, norm = optim.clip_by_global_norm(
            optim.tree_map(lambda _: next(flat), tp), 1.0)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-4)
        tp, ts = optim.adam_update(clipped, ts, tp, lr=3e-4)
        np.testing.assert_allclose(float(loss), float(jl),
                                   rtol=STEP_LOSS_RTOL)
        losses.append(float(loss))
    assert losses[2] < losses[0]

"""The port's LM families beyond dense (VLM, audio, MoE, SSM, hybrid:
models/layers.py, models/lm.py, launch/serve.py) against the JAX
package's, on the CPU.

Inputs are made with NumPy from a seed and handed to both packages; the
reference's weights are carried across with `lm.params_from_reference`, so
both compute the same function. On the CPU `layers.attention` takes its
plain route; the kernel routes' wiring is checked here with the kernels'
plain versions standing in for them, and the kernels themselves by
chip_smoke.py (phases 6, 14 and 15) and tests/test_torch_attention.py.

Tolerances (tests/test_torch_lm.py's, where they apply). The layers,
float32: rtol=atol=1e-5 (`F32_TOL`; the two packages sum the same
products in other orders). bfloat16: `BF16_TOL`, 2 ulps at 1 (2^-6) and
2% of the value (XLA's CPU fusions keep some intermediates in fp32 where
PyTorch rounds them). The SSD scan at fp32: `SSD_F32_TOL`, 1e-5 of each
value and of the output's largest magnitude (the chunk products sum up to
`chunk` terms).

The model, float32: `MODEL_F32_TOL` (2e-5) of each value and of its
tensor's largest magnitude; whisper at 2e-4 (`MODEL_F32_TOL_BY_ARCH`):
its cross-attention over near-argmax scores amplifies fp32 rounding, and
the reference's own fp32 logits lie about 1e-4 of the largest logit from
a float64 evaluation of the same weights (the port's, in float64), the
port's no farther.

The model, bfloat16. Attention without qk-norm is near an argmax at the
reference's init scales (tests/test_torch_lm.py), and an MoE token's
top-k choice can flip on a near-tie, so a bf16 run of either package
moves some tokens by O(1) against its fp32 run, each package at other
tokens: the reference's own bf16 run moves logits of every family but
mamba2 by 0.45 to 2.2 somewhere in the sequence. Two bf16 runs are
therefore not held elementwise: the logits (prefill and decode steps
pooled) and each cache by mean error against the reference's fp32 run,
at most twice the reference's own bf16 run's plus 2^-8, and the loss
within `MODEL_BF16_TOL` (0.1) of the reference's bf16 loss.
Prefill-then-decode: the reference's own 0.15
(tests/test_arch_smoke.py:84).
"""

import dataclasses
import functools
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import lm  # noqa: E402

FAMILIES = ("qwen2-vl-2b", "whisper-tiny", "phi3.5-moe-42b-a6.6b",
            "deepseek-moe-16b", "mamba2-370m", "hymba-1.5b")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2 ** -6)
SSD_F32_TOL = 1e-5
MODEL_F32_TOL = 2e-5
MODEL_F32_TOL_BY_ARCH = {"whisper-tiny": 2e-4}
MODEL_BF16_TOL = dict(rtol=0.1, atol=0.1)
# the prompt, past hymba's smoke window (16), so its windowed caches are
# rings; mamba2's chunk is 8, so its scan walks 5 chunks
B, S, GEN = 2, 40, 2


def _close(out, expect, dtype, **tol):
    tol = tol or (F32_TOL if dtype == "float32" else BF16_TOL)
    np.testing.assert_allclose(
        torch.as_tensor(out).float().numpy(), np.asarray(expect, np.float32),
        **tol)


def _both(arr, dtype):
    """One float32 NumPy array as a JAX array and a torch tensor of
    `dtype` (the same round-to-nearest-even to bf16 on both sides)."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return jnp.asarray(arr, jdt), torch.as_tensor(arr).to(tdt)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _configs(arch, dtype=None):
    jc, tc = jbase.smoke_config(arch), tbase.smoke_config(arch)
    if dtype:
        jc, tc = (dataclasses.replace(jc, dtype=dtype),
                  dataclasses.replace(tc, dtype=dtype))
    return jc, tc


def _params(tree_np):
    """A NumPy parameter tree as the JAX package's and the port's."""
    jtree = jax.tree.map(jnp.asarray, tree_np)
    return jtree, lm.params_from_reference(tree_np)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_mrope_matches_jax(dtype):
    """M-RoPE at qwen2-vl's sections (16, 24, 24) over head dim 128, with
    three position streams that differ."""
    x, = _normal(0, (2, 3, 5, 128))
    jx, tx = _both(x, dtype)
    pos3 = np.random.default_rng(1).integers(0, 3000, (3, 2, 5)).astype(
        np.int32)
    out = layers.apply_mrope(tx, torch.as_tensor(pos3), 1e6, (16, 24, 24))
    _close(out, jlayers.apply_mrope(jx, jnp.asarray(pos3), 1e6,
                                    (16, 24, 24)), dtype)
    assert out.dtype == tx.dtype


MOE_CASES = {
    # name: (E, top_k, capacity_factor, S)
    "top2": (4, 2, 1.25, 24),
    "top6 of 8": (8, 6, 1.25, 24),
    "top2 drops": (8, 2, 0.5, 40),
    "top6 drops": (8, 6, 0.5, 40),
}


def _moe_params(seed, E, d, f):
    router, w1, w3, w2 = _normal(seed, (d, E), (E, d, f), (E, d, f),
                                 (E, f, d))
    return {"router": router, "w1": w1 / np.sqrt(d), "w3": w3 / np.sqrt(d),
            "w2": w2 / np.sqrt(f)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_ffn_matches_jax(case, dtype):
    """`moe_ffn` op for op: the output and the aux loss. The "drops" cases
    run at capacity factor 0.5, so experts overflow and tokens are dropped
    (checked)."""
    E, k, cf, s = MOE_CASES[case]
    d, f = 32, 48
    raw = _moe_params(len(case), E, d, f)
    x, = _normal(3, (2, s, d))
    jx, tx = _both(x, dtype)
    jp = {n: (jnp.asarray(a) if n == "router" else _both(a, dtype)[0])
          for n, a in raw.items()}
    tp = {n: (torch.as_tensor(a) if n == "router" else _both(a, dtype)[1])
          for n, a in raw.items()}
    jout, jaux = jax.jit(functools.partial(
        jlayers.moe_ffn, top_k=k, capacity_factor=cf))(jp, jx)
    out, aux = layers.moe_ffn(tp, tx, top_k=k, capacity_factor=cf)
    assert out.dtype == tx.dtype and aux.dtype == torch.float32
    _close(out, jout, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if "drops" in case:
        C = int(cf * k * s / E)
        probs = torch.softmax(tx.float() @ tp["router"], -1)
        chosen = layers._top_k(probs, k)[1].reshape(2, -1)
        load = layers._one_hot_counts(chosen, E, torch.int64)
        assert int(load.max()) > C, "no expert overflowed its capacity"


def test_top_k_breaks_ties_to_the_lower_index():
    """`jax.lax.top_k` puts the lower index first on a tie; the port's
    `_top_k` does too."""
    probs = np.array([[0.1, 0.3, 0.3, 0.1, 0.2], [0.25, 0.25, 0.25, 0.25,
                                                   0.0]], np.float32)
    for k in (1, 2, 3, 4):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        tv, ti = layers._top_k(torch.as_tensor(probs), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv1d_matches_jax(dtype):
    """Both modes: the padded whole sequence, and streaming from a state
    (returning the new state)."""
    x, w, st = _normal(4, (2, 9, 24), (4, 24), (2, 3, 24))
    (jx, tx), (jw, tw), (js, ts) = (_both(a, dtype) for a in (x, w, st))
    _close(layers.causal_conv1d(tx, tw), jlayers.causal_conv1d(jx, jw),
           dtype)
    y, new = layers.causal_conv1d(tx, tw, state=ts)
    jy, jnew = jlayers.causal_conv1d(jx, jw, state=js)
    _close(y, jy, dtype)
    _close(new, jnew, dtype, rtol=0, atol=0)
    y1, _ = layers.causal_conv1d(tx[:, :1], tw, state=ts)
    jy1, _ = jlayers.causal_conv1d(jx[:, :1], jw, state=js)
    _close(y1, jy1, dtype)


def _ssd_inputs(seed, b=2, s=32, h=4, p=8, g=2, n=16):
    x, dt_raw, a, bm, cm, st = _normal(seed, (b, s, h, p), (b, s, h), (h,),
                                       (b, s, g, n), (b, s, g, n),
                                       (b, h, p, n))
    dt = np.log1p(np.exp(dt_raw - 1.0)).astype(np.float32)  # softplus
    A = -np.exp(0.3 * a).astype(np.float32)
    return x, dt, A, bm, cm, st


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
def test_ssd_chunked_matches_jax(dtype, init):
    """The chunked SSD scan (4 chunks of 8, 2 groups repeated over 4
    heads), from zeros and from an initial state: y and the final
    state."""
    x, dt, A, bm, cm, st = _ssd_inputs(5)
    (jx, tx), (jb, tb), (jc, tc) = (_both(a, dtype) for a in (x, bm, cm))
    jdt, tdt = jnp.asarray(dt), torch.as_tensor(dt)
    jA, tA = jnp.asarray(A), torch.as_tensor(A)
    kw_j = dict(chunk=8, init_state=jnp.asarray(st) if init else None)
    kw_t = dict(chunk=8, init_state=torch.as_tensor(st) if init else None)
    y, final = layers.ssd_chunked(tx, tdt, tA, tb, tc, **kw_t)
    jy, jfinal = jlayers.ssd_chunked(jx, jdt, jA, jb, jc, **kw_j)
    assert y.dtype == final.dtype == tx.dtype
    for got, want in ((y, jy), (final, jfinal)):
        if dtype == "float32":
            scale = float(np.abs(np.asarray(want)).max())
            _close(got, want, dtype, rtol=SSD_F32_TOL,
                   atol=SSD_F32_TOL * scale)
        else:
            _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_decode_step_matches_jax(dtype):
    x, dt, A, bm, cm, st = _ssd_inputs(6, s=1)
    (jx, tx), (jb, tb), (jc, tc), (js, ts) = (
        _both(a, dtype) for a in (x[:, 0], bm[:, 0], cm[:, 0], st))
    y, new = layers.ssd_decode_step(tx, torch.as_tensor(dt[:, 0]),
                                    torch.as_tensor(A), tb, tc, ts)
    jy, jnew = jlayers.ssd_decode_step(jx, jnp.asarray(dt[:, 0]),
                                       jnp.asarray(A), jb, jc, js)
    _close(y, jy, dtype)
    _close(new, jnew, dtype)


# ---------------------------------------------------------------------------
# attention routes
# ---------------------------------------------------------------------------


def test_attention_route_full_and_unmasked_decode():
    """The two rules this family brings, at whisper's full widths: its
    encoder (1536 x 1536) and prefill cross-attention (448 x 1536) take
    the flash kernel's full mode; its cross-attention at a decode step
    (one row, no mask) the decode kernel. Their boundaries: a window, a
    scale, a mask with Sq > 1, fp16, head dim 80, the CPU, a causal
    non-square call."""
    route = layers.attention_route
    w = tbase.get_config("whisper-tiny")
    h, d, se = w.num_heads, w.resolved_head_dim, w.encoder_seq
    full = dict(causal=False)
    assert route((4, h, se, d), (4, h, se, d), **full) == "flash"
    assert route((4, h, 448, d), (4, h, se, d), **full) == "flash"
    assert route((4, h, 1, d), (4, h, se, d), **full) == "decode"
    assert route((4, h, 448, d), (4, h, se, d), dtype=torch.float32,
                 **full) == "flash"
    assert route((4, h, 448, d), (4, h, se, d), use_pallas=True,
                 **full) == "flash"
    assert route((4, h, 1, d), (4, h, se, d), use_pallas=True,
                 **full) == "decode"
    # a q offset is no matter without a causal mask or window
    assert route((4, h, 7, d), (4, h, 9, d), q_offset=5, **full) == "flash"
    for kw in (dict(window=64), dict(softmax_scale=0.2),
               dict(dtype=torch.float16), dict(device="cpu"),
               dict(use_pallas=False)):
        assert route((4, h, 448, d), (4, h, se, d), **full, **kw) \
            == "plain", kw
        assert route((4, h, 1, d), (4, h, se, d), **full, **kw) \
            == "plain", kw
    assert route((4, h, 448, d), (4, h, se, d), kv_valid_len=5,
                 **full) == "plain"
    # head dim 80 (h2o-danube's) is a kernel's; 96 is none
    assert route((4, 32, 448, 80), (4, 8, 600, 80), **full) == "flash"
    assert route((4, 32, 1, 80), (4, 8, 600, 80), **full) == "decode"
    assert route((4, 32, 448, 96), (4, 8, 600, 96), **full) == "plain"
    assert route((4, 32, 1, 96), (4, 8, 600, 96), **full) == "plain"
    assert route((4, h, 448, d), (4, h, se, d), causal=True) == "plain"
    with pytest.raises(ValueError, match="no kernel takes"):
        route((4, h, 448, d), (4, h, se, d), window=64, use_pallas=True,
              **full)
    with pytest.raises(ValueError, match="use_pallas=True"):
        route((4, h, 1, d), (4, h, se, d), device="cpu", use_pallas=True,
              **full)


@pytest.fixture
def kernel_routes(monkeypatch):
    """`attention` routing as on the card, with the kernels' plain
    versions standing in for the kernels: each call's route, causal flag
    and decode valid_len recorded."""
    calls = []
    real_route, real_flash, real_decode = (
        layers.attention_route, layers.ops.flash_attention,
        layers.ops.decode_attention)

    def route(*args, device="cuda", **kw):
        return real_route(*args, device="cuda", **kw)

    def flash(q, k, v, *, causal, use_pallas, window=0):
        assert use_pallas is True
        calls.append(("flash", causal, tuple(q.shape), k.shape[2]))
        return real_flash(q, k, v, causal=causal, window=window,
                          use_pallas=False)

    def decode(q, k, v, valid_len, *, use_pallas):
        assert use_pallas is True
        calls.append(("decode", valid_len, tuple(q.shape), k.shape[2]))
        return real_decode(q, k, v, valid_len, use_pallas=False)

    monkeypatch.setattr(layers, "attention_route", route)
    monkeypatch.setattr(layers.ops, "flash_attention", flash)
    monkeypatch.setattr(layers.ops, "decode_attention", decode)
    return calls


def test_whisper_kernel_routes_wiring(kernel_routes):
    """Whisper's prefill and decode step with `attention` routing as on
    the card (the kernels' plain versions standing in): every call takes a
    kernel route, the encoder and the cross-attention in full mode
    (causal=False), the decoder's self-attention causal; at a decode step
    the cross-attention reads the whole cache through one device int
    filled once; and the logits equal the plain route's. One head of 64
    (a head dim the kernels take) on the smoke widths."""
    _, tc = _configs("whisper-tiny", "float32")
    tc = dataclasses.replace(tc, num_heads=1, num_kv_heads=1)
    params = lm.init_params(tc, torch.Generator().manual_seed(3), "cpu")
    rng = np.random.default_rng(3)
    batch, _ = tserve.serve_inputs(tc, rng, 2, 12, "cpu")
    batch["frames"] = batch["frames"].float()
    with torch.inference_mode():
        logits, caches = lm.prefill(tc, params, batch, max_len=16)
        step, _ = lm.decode_step(tc, params, batch["tokens"][:, :1], caches,
                                 12)
    n, se, h = tc.num_layers, tc.encoder_seq, tc.num_heads
    flash = [c for c in kernel_routes if c[0] == "flash"]
    decode = [c for c in kernel_routes if c[0] == "decode"]
    assert len(kernel_routes) == 3 * n + 2 * n
    assert sorted((c[1], c[2][2], c[3]) for c in flash) == sorted(
        [(False, se, se)] * tc.encoder_layers + [(True, 12, 12)] * n
        + [(False, 12, se)] * n)
    cross = [c[1] for c in decode if c[3] == se]
    assert len(cross) == n and all(int(v) == se for v in cross)
    assert all(v is cross[0] for v in cross), "valid_len made per call"
    assert all(isinstance(c[1], torch.Tensor) for c in decode)
    with torch.inference_mode():
        plain_logits, caches = lm.prefill(tc, params, batch, max_len=16,
                                          use_pallas=False)
        plain_step, _ = lm.decode_step(tc, params, batch["tokens"][:, :1],
                                       caches, 12, use_pallas=False)
    torch.testing.assert_close(logits, plain_logits, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(step, plain_step, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _tree_specs(tree):
    if isinstance(tree, dict):
        return {k: _tree_specs(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_params_has_the_reference_tree(arch):
    """Keys, shapes and dtypes of `init_params` equal the reference's
    (`jax.eval_shape`): whisper's encoder, cross stack and learned
    positions, the MoE's router and [L, E, d, f] experts (DeepSeek's
    shared experts and dense layer 0), the SSM's conv and scan params,
    hymba's global blocks; and the draws repeat for a seed."""
    jc, tc = _configs(arch)
    want = _tree_specs(jax.eval_shape(functools.partial(jlm.init_params, jc),
                                      jax.random.PRNGKey(0)))
    params = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert _tree_specs(params) == want
    assert abs(float(params["embed"].float().std()) - 0.02) < 2e-3
    again = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(again)))
    # the trees cross: the reference's weights carried over keep the specs
    carried = lm.params_from_reference(jax.tree.map(np.asarray, jax.jit(
        functools.partial(jlm.init_params, jc))(jax.random.PRNGKey(0))))
    assert _tree_specs(carried) == want


def _leaves(prefix, tree):
    """{prefix/path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(f"{prefix}/{k}", v))
        return out
    return {prefix: tree}


def _family_batch(cfg, tokens, dtype, seed):
    """The prompt batch of `tokens` [B, T] (NumPy int32) with the family's
    extras, as (JAX batch, torch batch): whisper's frames, the VLM's patch
    embeddings (8 smoke patches) and M-RoPE positions, in `dtype`."""
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.as_tensor(tokens)}
    b, t = tokens.shape
    if cfg.encoder_decoder:
        frames, = _normal(seed, (b, cfg.encoder_seq, cfg.d_model))
        jb["frames"], tb["frames"] = _both(frames, dtype)
    if cfg.family == "vlm":
        patches, = _normal(seed + 1, (b, cfg.num_patches, cfg.d_model))
        jb["patch_embeds"], tb["patch_embeds"] = _both(patches, dtype)
        total = cfg.num_patches + t
        pos3 = np.broadcast_to(np.arange(total, dtype=np.int32)[None, None],
                               (3, b, total)).copy()
        jb["pos3"], tb["pos3"] = jnp.asarray(pos3), torch.as_tensor(pos3)
    return jb, tb


def _prefix(cfg) -> int:
    return cfg.num_patches if cfg.family == "vlm" else 0


def _max_len(cfg) -> int:
    """The caches' slots. The VLM's hold one slot fewer than the prefix,
    prompt and decode steps need, as the reference's serve sizes them (the
    prefix not counted), so its last decode step writes the clamped last
    slot."""
    return _prefix(cfg) + S + GEN - (1 if cfg.family == "vlm" else 0)


def _pos3_step(idx, b, xp):
    return xp.broadcast_to(xp.asarray(idx), (3, b, 1))


def _run(cfg, prefill, decode_step, loss_fn, as_array, batch, tokens):
    """Prefill over the prompt, GEN teacher-forced decode steps and the
    loss, in either package: {name: float32 array}."""
    out = {}
    logits, caches = prefill(batch)
    out["prefill logits"] = as_array(logits)
    for name, t in _leaves("prefill cache", caches).items():
        out[name] = as_array(t)
    idx0 = _prefix(cfg) + S
    for t in range(GEN):
        logits, caches = decode_step(tokens[:, S + t:S + t + 1], caches,
                                     idx0 + t)
        out[f"decode {t} logits"] = as_array(logits)
    for name, t in _leaves("decode cache", caches).items():
        out[name] = as_array(t)
    out["loss"] = as_array(loss_fn())
    return out


@functools.lru_cache(maxsize=None)
def _reference_runs(arch):
    """The JAX package's `_run` at the config's bf16 and, with the same
    weights cast, at fp32; and those weights as NumPy arrays."""
    jc, _ = _configs(arch)
    runs = {"params": {}, "inputs": {}}
    p16 = jax.jit(functools.partial(jlm.init_params, jc))(
        jax.random.PRNGKey(7))
    tokens = np.random.default_rng(len(arch)).integers(
        0, jc.vocab_size, (B, S + GEN)).astype(np.int32)
    runs["tokens"] = tokens
    vlm = jc.family == "vlm"
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(jc, dtype=dtype)
        params = jax.tree.map(lambda a, d=dtype: a.astype(d)
                              if a.dtype != jnp.float32 else a, p16)
        runs["params"][dtype] = jax.tree.map(np.asarray, params)
        prompt, _ = _family_batch(c, tokens[:, :S], dtype, len(arch))
        full, _ = _family_batch(c, tokens, dtype, len(arch))
        pre = jax.jit(lambda p, b, c=c: jlm.prefill(c, p, b,
                                                    max_len=_max_len(c)))
        dec = jax.jit(lambda p, tok, caches, i, c=c: jlm.decode_step(
            c, p, tok, caches, i,
            pos3=_pos3_step(i, B, jnp).astype(jnp.int32) if vlm else None))
        loss = jax.jit(lambda p, b, c=c: jlm.loss_fn(c, p, b, remat=False))
        runs[dtype] = _run(
            c, lambda b, p=params: pre(p, b),
            lambda tok, caches, i, p=params: dec(
                p, jnp.asarray(tok), caches, jnp.asarray(i, jnp.int32)),
            lambda p=params, b=full: loss(p, b),
            lambda a: np.asarray(a, np.float32), prompt, tokens)
    return runs


def _port_run(arch, dtype, params, tokens):
    _, tc = _configs(arch, dtype)
    _, prompt = _family_batch(tc, tokens[:, :S], dtype, len(arch))
    _, full = _family_batch(tc, tokens, dtype, len(arch))
    vlm = tc.family == "vlm"

    def decode(tok, caches, i):
        idx = torch.tensor(i, dtype=torch.int32)
        return lm.decode_step(
            tc, params, torch.as_tensor(tok), caches, idx,
            pos3=_pos3_step(idx, B, torch) if vlm else None)

    with torch.inference_mode():
        return _run(
            tc, lambda b: lm.prefill(tc, params, b, max_len=_max_len(tc)),
            decode, lambda: lm.loss_fn(tc, params, full),
            lambda a: a.float().numpy().copy(), prompt, tokens)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_and_loss_match_jax_fp32(arch):
    """With the reference's weights carried across, at fp32: prefill's
    last-token logits and every cache (attention K/V, whisper's cross K/V,
    the SSM's conv and scan states), GEN teacher-forced decode steps'
    logits and the caches after them, and the loss (with the MoE's aux).
    Each element within MODEL_F32_TOL of itself and of its tensor's
    largest magnitude. hymba's windowed caches are rings (prompt 40 >
    window 16); the VLM's last decode step writes its cache's clamped last
    slot."""
    ref = _reference_runs(arch)
    got = _port_run(arch, "float32",
                    lm.params_from_reference(ref["params"]["float32"]),
                    ref["tokens"])
    tol = MODEL_F32_TOL_BY_ARCH.get(arch, MODEL_F32_TOL)
    assert set(got) == set(ref["float32"])
    for name, want in ref["float32"].items():
        assert got[name].shape == want.shape, name
        np.testing.assert_allclose(
            got[name], want, rtol=tol,
            atol=tol * max(1.0, float(np.abs(want).max())), err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_decode_and_loss_match_jax_bf16(arch):
    """The same run at the config's bf16, held by the module docstring's
    bf16 rule: the pooled logits and each cache by mean error against the
    reference's fp32 run, and the loss within MODEL_BF16_TOL of the
    reference's bf16 loss."""
    ref = _reference_runs(arch)
    got = _port_run(arch, "bfloat16",
                    lm.params_from_reference(ref["params"]["bfloat16"]),
                    ref["tokens"])
    want, truth = ref["bfloat16"], ref["float32"]
    assert set(got) == set(want)
    for name in want:
        assert got[name].shape == want[name].shape, name

    def mean_err(run, names):
        return np.mean([np.abs(run[n] - truth[n]).mean() for n in names])

    logits = [n for n in want if "logits" in n]
    for names in [logits] + [[n] for n in want if "cache" in n]:
        err, ref_err = mean_err(got, names), mean_err(want, names)
        assert err <= 2 * ref_err + 2 ** -8, (names, err, ref_err)
    np.testing.assert_allclose(got["loss"], want["loss"], **MODEL_BF16_TOL)


@pytest.mark.parametrize("arch", [a for a in FAMILIES
                                  if not jbase.smoke_config(a).moe])
def test_prefill_then_decode_consistent(arch):
    """The reference's own check (tests/test_arch_smoke.py:44-87) on the
    port, at the config's dtype and the reference's tolerance: decoding
    token S after a prefill of S tokens gives the logits of a prefill over
    S + 1 tokens (the VLM with its patch prefix and M-RoPE positions).
    The MoE family is exempt, as in the reference: capacity-bucketed
    routing depends on the whole sequence."""
    _, tc = _configs(arch)
    params = lm.init_params(tc, torch.Generator().manual_seed(1), "cpu")
    n = 16
    tokens = np.random.default_rng(1).integers(
        0, tc.vocab_size, (2, n + 1)).astype(np.int32)
    _, prompt = _family_batch(tc, tokens[:, :n], tc.dtype, 2)
    _, full = _family_batch(tc, tokens, tc.dtype, 2)
    prefix = _prefix(tc)
    idx = torch.tensor(prefix + n, dtype=torch.int32)
    with torch.inference_mode():
        _, caches = lm.prefill(tc, params, prompt, max_len=prefix + n + 8)
        dec, _ = lm.decode_step(
            tc, params, torch.as_tensor(tokens[:, n:]), caches, idx,
            pos3=_pos3_step(idx, 2, torch) if tc.family == "vlm" else None)
        want, _ = lm.prefill(tc, params, full, max_len=prefix + n + 8)
    np.testing.assert_allclose(dec.float().numpy(), want.float().numpy(),
                               rtol=0.15, atol=0.15)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b", "deepseek-moe-16b"])
def test_moe_chunked_dispatch_matches_jax(arch):
    """A 2048-token sequence dispatches in two 1024-token chunks, each
    with its own capacity, and the aux loss is their mean: the loss at
    fp32 on the smoke widths, held to the reference's at MODEL_F32_TOL.
    The chunks are seen to matter: one whole-sequence dispatch gives
    another aux loss."""
    jc, tc = _configs(arch, "float32")
    p_np = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jlm.init_params, jc))(jax.random.PRNGKey(2)))
    jp, tp = _params(p_np)
    tokens = np.random.default_rng(2).integers(
        0, jc.vocab_size, (1, 2 * lm.MOE_CHUNK)).astype(np.int32)
    want = float(jax.jit(lambda p, t: jlm.loss_fn(
        jc, p, {"tokens": t}, remat=False))(jp, jnp.asarray(tokens)))
    with torch.inference_mode():
        got = float(lm.loss_fn(tc, tp, {"tokens": torch.as_tensor(tokens)}))
        x = torch.randn(1, 2 * lm.MOE_CHUNK, tc.d_model,
                        generator=torch.Generator().manual_seed(0))
        blk = lm._layer_of(tp["blocks"], 0)
        _, chunked = lm._mlp_forward(tc, blk, x)
        moe_p = {k: blk[k] for k in ("router", "w1", "w3", "w2")}
        _, whole = layers.moe_ffn(moe_p, x, top_k=tc.experts_per_token,
                                  capacity_factor=tc.moe_capacity_factor)
    np.testing.assert_allclose(got, want, rtol=MODEL_F32_TOL,
                               atol=MODEL_F32_TOL)
    assert float(chunked) != float(whole)


@pytest.mark.parametrize("s", [lm.MOE_CHUNK, lm.MOE_CHUNK + 512])
def test_moe_dispatch_unchunked_matches_jax(s):
    """A sequence of exactly MOE_CHUNK tokens, or a longer one that does
    not divide into chunks, dispatches whole: `_mlp_forward` on
    deepseek's smoke widths (shared experts included) at fp32, the output
    at MODEL_F32_TOL and the aux loss at 1e-6 of the reference's, and
    bit for bit one whole-sequence `moe_ffn` plus the shared experts."""
    jc, tc = _configs("deepseek-moe-16b", "float32")
    p_np = jax.tree.map(np.asarray, jax.jit(functools.partial(
        jlm.init_params, jc))(jax.random.PRNGKey(4)))
    blk_np = jax.tree.map(lambda a: a[0], p_np["blocks"])
    jblk, tblk = _params(blk_np)
    x, = _normal(4, (1, s, tc.d_model))
    jout, jaux = jax.jit(functools.partial(jlm._mlp_forward, jc))(
        jblk, jnp.asarray(x))
    with torch.inference_mode():
        out, aux = lm._mlp_forward(tc, tblk, torch.as_tensor(x))
        moe_p = {k: tblk[k] for k in ("router", "w1", "w3", "w2")}
        whole, whole_aux = layers.moe_ffn(
            moe_p, torch.as_tensor(x), top_k=tc.experts_per_token,
            capacity_factor=tc.moe_capacity_factor)
    jout = np.asarray(jout)
    np.testing.assert_allclose(
        out.numpy(), jout, rtol=MODEL_F32_TOL,
        atol=MODEL_F32_TOL * max(1.0, float(np.abs(jout).max())))
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    assert float(aux) == float(whole_aux)
    assert "shared_w1" in tblk and not torch.equal(out, whole)


def test_dec_pos_clamps_as_the_reference():
    """Whisper's learned positions at `pos_offset`: a start past the table
    clamps to its last rows, as `dynamic_slice_in_dim` does, and a tensor
    start gives the int start's rows."""
    table = torch.arange(20 * 3, dtype=torch.float32).reshape(20, 3)
    jtable = jnp.asarray(table.numpy())
    for start, s in ((0, 4), (5, 1), (19, 1), (18, 4), (40, 2)):
        want = np.asarray(jax.lax.dynamic_slice_in_dim(jtable, start, s, 0))
        for st in (start, torch.tensor(start, dtype=torch.int32)):
            np.testing.assert_array_equal(lm._dec_pos(table, st, s).numpy(),
                                          want)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _reference_serve_inputs(cfg, batch, prompt_len, seed):
    """The reference's construction of the served batch, verbatim from
    src/repro/launch/serve.py:26-43."""
    rng = np.random.default_rng(seed)
    batch_in = {"tokens": jnp.asarray(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)), jnp.int32)}
    if cfg.encoder_decoder:
        batch_in["frames"] = jnp.asarray(
            rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)),
            jnp.bfloat16)
    if cfg.family == "vlm":
        p = min(cfg.num_patches, 8)
        batch_in["patch_embeds"] = jnp.asarray(
            rng.normal(size=(batch, p, cfg.d_model)), jnp.bfloat16)
        total = p + prompt_len
        batch_in["pos3"] = jnp.broadcast_to(
            jnp.arange(total)[None, None], (3, batch, total)).astype(jnp.int32)
        prompt_len = total
    return batch_in, prompt_len


@pytest.mark.parametrize("arch,prompt_len", [("whisper-tiny", 448),
                                             ("qwen2-vl-2b", 2048)])
def test_serve_inputs_match_the_reference_bitwise(arch, prompt_len):
    """`serve_inputs` at the full configs and the card's traffic (batch 4;
    whisper's 1536 frames of width 384, the VLM's 8 patches of width 1536)
    equals the reference's construction bit for bit, the bf16 rounding of
    the float64 draws included."""
    cfg = tbase.get_config(arch)
    got, total = tserve.serve_inputs(cfg, np.random.default_rng(0), 4,
                                     prompt_len, "cpu")
    want, want_total = _reference_serve_inputs(jbase.get_config(arch), 4,
                                               prompt_len, 0)
    assert total == want_total and set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype), name
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(), w.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_on_cpu_repeats_and_matches_a_stepwise_run(arch):
    """`serve` on each family returns [batch, gen] tokens and two clock
    readings; it repeats for a seed, and its first token is the argmax of
    a prefill with the same weights and inputs."""
    batch, prompt_len, gen = 2, 24, 9
    seqs, t_pre, t_dec = tserve.serve(arch, batch=batch,
                                      prompt_len=prompt_len, gen=gen,
                                      device="cpu")
    assert seqs.shape == (batch, gen) and t_pre > 0 and t_dec > 0
    again, _, _ = tserve.serve(arch, batch=batch, prompt_len=prompt_len,
                               gen=gen, device="cpu")
    assert torch.equal(seqs, again)
    tc = tbase.smoke_config(arch)
    params = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    inputs, _ = tserve.serve_inputs(tc, np.random.default_rng(0), batch,
                                    prompt_len, "cpu")
    with torch.inference_mode():
        logits, _ = lm.prefill(tc, params, inputs,
                               max_len=prompt_len + gen)
    assert torch.equal(seqs[:, 0], logits.argmax(-1).to(seqs.dtype))


def test_serve_cli_serves_a_family():
    """`python -m repro_torch.launch.serve --arch whisper-tiny --device
    cpu` prints the reference's two lines."""
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "whisper-tiny", "--device", "cpu", "--gen", "8"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=120, check=True)
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 2, proc.stdout
    assert re.match(r"\[serve\] generated \(4, 8\) tokens", lines[0])
    assert lines[1].startswith("[serve] sample: [")

"""The port's LM serving path (configs, models/layers.py, models/lm.py,
launch/serve.py) against the JAX package's, on the CPU: the configs, the
dense layers and the dense family (the other families:
tests/test_torch_lm_families.py).

Inputs are made with NumPy from a seed and handed to both packages; the
reference's weights are carried across with `lm.params_from_reference`, so
both compute the same function. On the CPU `layers.attention` takes its
plain route (the reference's math in PyTorch); the kernels it routes to on
the card are held against the same plain versions by chip_smoke.py (phase
14) and tests/test_torch_attention.py.

Tolerances. The layers, float32: rtol=atol=1e-5 (the two packages sum
the same products in other orders). bfloat16: both sides round every op's
output to bf16, but XLA's CPU fusions keep some intermediates in fp32
where PyTorch rounds them: `BF16_TOL`, 2 ulps at 1 (2^-6) and 2% of the
value. The model, float32: `MODEL_F32_TOL` (2e-5) of each value and of
its tensor's largest magnitude. The model, bfloat16: each output's mean
error against the reference's fp32 run at most twice the reference's own
bf16 run's, and the logits and loss within `MODEL_BF16_TOL` (0.1) of the
reference's bf16 run: 3 bf16 ulps of a logit of 4, the size of bf16's own
rounding through two layers.
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

DENSE = ("qwen1.5-0.5b", "qwen3-4b", "h2o-danube-1.8b", "yi-6b")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2 ** -6)
MODEL_F32_TOL = 2e-5
MODEL_BF16_TOL = dict(rtol=0.1, atol=0.1)
# the prompt, past h2o-danube's smoke window (32), so its cache is a ring
B, S, GEN, MAX_LEN = 2, 40, 2, 48


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
    """The smoke config of `arch` in both packages, at `dtype` if given."""
    jc, tc = jbase.smoke_config(arch), tbase.smoke_config(arch)
    if dtype:
        jc, tc = (dataclasses.replace(jc, dtype=dtype),
                  dataclasses.replace(tc, dtype=dtype))
    return jc, tc


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", jbase.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    """Every field of the full and the smoke config, and the analytic
    parameter counts, equal the reference's."""
    assert tbase.list_archs() == jbase.list_archs() == tbase.ARCH_IDS
    for jget, tget in ((jbase.get_config, tbase.get_config),
                       (jbase.smoke_config, tbase.smoke_config)):
        jc, tc = jget(arch), tget(arch)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert (tc.resolved_head_dim, tc.sub_quadratic) == (
            jc.resolved_head_dim, jc.sub_quadratic)
    assert tbase.shape_cells(arch) == jbase.shape_cells(arch)
    assert ({k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()})
    assert isinstance(tbase.SHAPES["train_4k"], tbase.ShapeConfig)
    with pytest.raises(ValueError, match="unknown arch"):
        tbase.get_config("gpt-2")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_rope_and_mlps_match_jax(dtype):
    x, scale, bias, w1, w3, w2, b1, b2 = _normal(
        0, (2, 5, 64), (64,), (64,), (64, 160), (64, 160), (160, 64),
        (160,), (64,))
    # the model's scales: weights at 1/sqrt(fan_in)
    w1, w3, w2 = w1 / 8, w3 / 8, w2 / np.sqrt(160)
    jx, tx = _both(x, dtype)
    js, ts = jnp.asarray(scale), torch.as_tensor(scale)
    jb, tb = jnp.asarray(bias), torch.as_tensor(bias)
    _close(layers.rmsnorm(tx, ts), jlayers.rmsnorm(jx, js), dtype)
    _close(layers.layernorm(tx, ts, tb), jlayers.layernorm(jx, js, jb), dtype)
    np.testing.assert_array_equal(layers.rope_freqs(16, 1e6),
                                  jlayers.rope_freqs(16, 1e6))
    q, = _normal(1, (2, 4, 5, 16))
    jq, tq = _both(q, dtype)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    _close(layers.apply_rope(tq, torch.as_tensor(pos)[:, None, :], 1e4),
           jlayers.apply_rope(jq, jnp.asarray(pos)[:, None, :], 1e4), dtype)
    jp = {n: _both(a, dtype)[0] for n, a in
          (("w1", w1), ("w3", w3), ("w2", w2), ("b1", b1), ("b2", b2))}
    tp = {n: _both(a, dtype)[1] for n, a in
          (("w1", w1), ("w3", w3), ("w2", w2), ("b1", b1), ("b2", b2))}
    _close(layers.gated_mlp(tp, tx), jlayers.gated_mlp(jp, jx), dtype)
    _close(layers.gelu_mlp(tp, tx), jlayers.gelu_mlp(jp, jx), dtype)


ATTN_CASES = {
    # name: (Hq, Hkv, Sq, Skv, D, kwargs)
    "mha causal": (4, 4, 64, 64, 16, dict(causal=True)),
    "gqa4 causal": (8, 2, 64, 64, 16, dict(causal=True)),
    "gqa4 full": (8, 2, 48, 80, 16, dict(causal=False)),
    "window": (4, 2, 64, 64, 16, dict(causal=True, window=24)),
    "q_offset window": (4, 2, 8, 64, 16, dict(causal=True, window=20,
                                                q_offset=56)),
    "decode valid": (8, 2, 1, 96, 64, dict(causal=False, kv_valid_len=57)),
    "decode scale": (4, 4, 1, 32, 16, dict(causal=False, kv_valid_len=32,
                                           softmax_scale=0.3)),
    # the reference's blockwise custom-VJP path (Sq * Skv > 2^20 and
    # divisible blocks), tests/test_kernels.py:225's shape
    "blockwise": (2, 2, 2048, 2048, 64, dict(causal=True)),
    "blockwise gqa window": (4, 2, 2048, 2048, 64, dict(causal=True,
                                                          window=300)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_matches_jax(case, dtype):
    """`layers.attention` (the plain route on the CPU) against the
    reference's on the direct and the blockwise path. The blockwise path
    rounds the unnormalised p to bf16 and divides after PV, the direct one
    rounds the normalised p: bf16 there is held at BF16_TOL too."""
    hq, hkv, sq, skv, d, kw = ATTN_CASES[case]
    q, k, v = _normal(hq * sq + d, (1, hq, sq, d), (1, hkv, skv, d),
                      (1, hkv, skv, d))
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    jkw = dict(kw)
    tkw = dict(kw)
    if "kv_valid_len" in kw:
        jkw["kv_valid_len"] = jnp.asarray(kw["kv_valid_len"], jnp.int32)
        tkw["kv_valid_len"] = torch.tensor(kw["kv_valid_len"],
                                           dtype=torch.int32)
    before = layers.ROUTES["plain"]
    out = layers.attention(tq, tk, tv, **tkw)
    assert layers.ROUTES["plain"] == before + 1
    assert out.shape == (1, hq, sq, d) and out.dtype == tq.dtype
    _close(out, jlayers.attention(jq, jk, jv, **jkw), dtype)


def test_plain_attention_chunks_give_the_unchunked_result(monkeypatch):
    """The plain route walks q in chunks past PLAIN_SCORE_ELEMS; rows are
    independent, so a 7-row chunking equals one chunk (within fp32
    rounding: the library blocks its products by shape)."""
    q, k, v = (torch.as_tensor(a) for a in _normal(
        3, (1, 4, 50, 16), (1, 2, 50, 16), (1, 2, 50, 16)))
    whole = layers.attention(q, k, v, causal=True, window=9)
    monkeypatch.setattr(layers, "PLAIN_SCORE_ELEMS", 4 * 50 * 7)
    torch.testing.assert_close(
        layers.attention(q, k, v, causal=True, window=9), whole,
        rtol=1e-6, atol=1e-6)


def test_attention_route():
    """The route rule at full widths: qwen3-4b's prefill takes the flash
    kernel and its decode the decode kernel; so do h2o-danube's (head dim
    80, window 4096) prefill, training and decode shapes, and a windowed
    prompt past its window (the flash kernel's band); a head dim the
    kernels do not take, a q offset, a scale, fp16, a non-causal windowed
    call and a windowed decode call take the plain route; the CPU always
    does. use_pallas=True raises on the CPU and outside the kernels'
    contract."""
    route = layers.attention_route
    q3 = tbase.get_config("qwen3-4b")
    hq, hkv, hd = q3.num_heads, q3.num_kv_heads, q3.resolved_head_dim
    assert route((8, hq, 2048, hd), (8, hkv, 2048, hd)) == "flash"
    assert route((8, hq, 1, hd), (8, hkv, 2112, hd), causal=False,
                 kv_valid_len=torch.tensor(2049)) == "decode"
    assert route((8, hq, 2048, hd), (8, hkv, 2048, hd),
                 dtype=torch.float32) == "flash"
    assert route((8, hq, 2048, hd), (8, hkv, 2048, hd), device="cpu") \
        == "plain"
    dan = tbase.get_config("h2o-danube-1.8b")
    assert dan.resolved_head_dim == 80
    dq, dkv = (8, 32, 2048, 80), (8, 8, 2048, 80)
    w = dan.sliding_window
    assert w == 4096
    assert route(dq, dkv, window=w) == "flash"
    assert route(dq, dkv, window=w, device="cpu") == "plain"
    # danube's training shape (seq 8192: the band is live) and its prefill
    # past the window, bf16 and fp32
    for dt in (torch.bfloat16, torch.float32):
        assert route((1, 32, 8192, 80), (1, 8, 8192, 80), window=w,
                     dtype=dt) == "flash"
    assert route((4, 32, 8192, 80), (4, 8, 8192, 80), window=w,
                 use_pallas=True) == "flash"
    assert route((8, 32, 1, 80), (8, 8, 4096, 80), causal=False,
                 kv_valid_len=5) == "decode"
    assert route((8, 32, 1, 80), (8, 8, 4096, 80), causal=False,
                 kv_valid_len=5, device="cpu") == "plain"
    # a window is a no-op up to its length, and the kernel's band past it
    assert route((2, 32, 4096, 128), (2, 8, 4096, 128), window=4096) \
        == "flash"
    assert route((2, 32, 4097, 128), (2, 8, 4097, 128), window=4096) \
        == "flash"
    assert route((2, 32, 4097, 128), (2, 8, 4097, 128), window=4096,
                 device="cpu") == "plain"
    # a windowed decode call and a non-causal windowed call stay plain
    assert route((2, 32, 1, 128), (2, 8, 64, 128), causal=False,
                 kv_valid_len=3, window=16) == "plain"
    assert route((2, 32, 1, 80), (2, 8, 4096, 80), causal=False,
                 kv_valid_len=3, window=w) == "plain"
    assert route((2, 32, 64, 128), (2, 8, 64, 128), causal=False,
                 window=16) == "plain"
    assert route((2, 32, 64, 96), (2, 8, 64, 96)) == "plain"
    # the route takes a band at D 128 in fp32 too: the forward kernel takes
    # it, and the fp32 backward kernel refuses it loudly (no model has one)
    assert route((2, 32, 4097, 128), (2, 8, 4097, 128), window=4096,
                 dtype=torch.float32) == "flash"
    assert route((2, 32, 4096, 128), (2, 8, 4096, 128), window=4096,
                 dtype=torch.float32) == "flash"
    assert route((1, 32, 8192, 80), (1, 8, 8192, 80), window=w,
                 dtype=torch.float32) == "flash"
    assert route((2, 32, 64, 128), (2, 8, 64, 128), q_offset=5) == "plain"
    assert route((2, 32, 64, 128), (2, 8, 64, 128),
                 q_offset=torch.tensor(0)) == "plain"
    assert route((2, 32, 64, 128), (2, 8, 64, 128), softmax_scale=0.1) \
        == "plain"
    assert route((2, 32, 64, 128), (2, 8, 64, 128), dtype=torch.float16) \
        == "plain"
    assert route((2, 32, 64, 128), (2, 8, 64, 128), use_pallas=False) \
        == "plain"
    assert route((2, 32, 64, 128), (2, 8, 64, 128), use_pallas=True) \
        == "flash"
    with pytest.raises(ValueError, match="use_pallas=True"):
        route((2, 32, 64, 128), (2, 8, 64, 128), device="cpu",
              use_pallas=True)
    with pytest.raises(ValueError, match="no kernel takes"):
        route((2, 32, 64, 96), (2, 8, 64, 96), use_pallas=True)
    with pytest.raises(ValueError, match="no kernel takes"):
        route((2, 32, 64, 128), (2, 8, 64, 128), causal=False, window=16,
              use_pallas=True)
    q = torch.zeros(1, 4, 8, 64)
    with pytest.raises(ValueError, match="use_pallas=True"):
        layers.attention(q, q, q, use_pallas=True)
    assert set(layers.ROUTES) <= set(layers.ATTENTION_ROUTES)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _tree_specs(tree):
    if isinstance(tree, dict):
        return {k: _tree_specs(v) for k, v in tree.items()}
    return tuple(tree.shape), str(tree.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", DENSE + ("gelu-layernorm",))
def test_init_params_has_the_reference_tree(arch):
    """Keys, shapes and dtypes of `init_params` equal the reference's
    (`jax.eval_shape`); the draws follow its scales, fan_in included: the
    reference takes a weight's first dim, which for a stacked [L, in, out]
    weight is L. "gelu-layernorm" is qwen3-4b's smoke config with the
    whisper-style norm and MLP."""
    jc, tc = _variant(arch)
    want = _tree_specs(jax.eval_shape(functools.partial(jlm.init_params, jc),
                                      jax.random.PRNGKey(0)))
    params = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert _tree_specs(params) == want
    assert abs(float(params["embed"].float().std()) - 0.02) < 2e-3
    wq = params["blocks"]["wq"].float()
    assert abs(float(wq.std()) * np.sqrt(tc.num_layers) - 1.0) < 0.05
    again = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(params), jax.tree.leaves(again)))


def _variant(arch, dtype=None):
    if arch == "gelu-layernorm":
        jc, tc = _configs("qwen3-4b", dtype)
        kw = dict(norm="layernorm", mlp="gelu", name="qwen3-4b-gelu-ln")
        return dataclasses.replace(jc, **kw), dataclasses.replace(tc, **kw)
    return _configs(arch, dtype)


def _run(prefill, decode_step, loss_fn, as_array, tokens):
    """Prefill over the prompt, GEN teacher-forced decode steps and the
    loss, in either package: {name: float32 array}."""
    out = {}
    logits, caches = prefill(tokens[:, :S])
    out["prefill logits"] = as_array(logits)
    for name, t in caches["blocks"]["attn"].items():
        out[f"prefill cache {name}"] = as_array(t)
    for t in range(GEN):
        logits, caches = decode_step(tokens[:, S + t:S + t + 1], caches,
                                     S + t)
        out[f"decode {t} logits"] = as_array(logits)
    for name, t in caches["blocks"]["attn"].items():
        out[f"decode cache {name}"] = as_array(t)
    out["loss"] = as_array(loss_fn(tokens))
    return out


@functools.lru_cache(maxsize=None)
def _reference_runs(arch):
    """The JAX package's `_run` at the config's bf16 and, with the same
    weights cast, at fp32; and those weights as NumPy arrays."""
    jc, _ = _variant(arch)
    runs = {"params": {}}
    p16 = jlm.init_params(jc, jax.random.PRNGKey(7))
    tokens = np.random.default_rng(len(arch)).integers(
        0, jc.vocab_size, (B, S + GEN)).astype(np.int32)
    runs["tokens"] = tokens
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(jc, dtype=dtype)
        params = jax.tree.map(lambda a, d=dtype: a.astype(d), p16)
        runs["params"][dtype] = jax.tree.map(np.asarray, params)
        pre = jax.jit(lambda p, tok, c=c: jlm.prefill(
            c, p, {"tokens": tok}, max_len=MAX_LEN))
        dec = jax.jit(lambda p, tok, caches, i, c=c: jlm.decode_step(
            c, p, tok, caches, i))
        loss = jax.jit(lambda p, tok, c=c: jlm.loss_fn(
            c, p, {"tokens": tok}, remat=False))
        runs[dtype] = _run(
            lambda tok, p=params: pre(p, jnp.asarray(tok)),
            lambda tok, caches, i, p=params: dec(
                p, jnp.asarray(tok), caches, jnp.asarray(i, jnp.int32)),
            lambda tok, p=params: loss(p, jnp.asarray(tok)),
            lambda a: np.asarray(a, np.float32), tokens)
    return runs


def _port_run(tc, params, tokens):
    with torch.inference_mode():
        return _run(
            lambda tok: lm.prefill(tc, params, {"tokens": tok},
                                   max_len=MAX_LEN),
            lambda tok, caches, i: lm.decode_step(
                tc, params, tok, caches, torch.tensor(i, dtype=torch.int32)),
            lambda tok: lm.loss_fn(tc, params, {"tokens": tok}),
            lambda a: a.float().numpy().copy(), torch.as_tensor(tokens))


@pytest.mark.parametrize("arch", DENSE + ("gelu-layernorm",))
def test_prefill_decode_and_loss_match_jax_fp32(arch):
    """With the reference's weights carried across, at fp32: prefill's
    last-token logits and caches, GEN teacher-forced decode steps' logits
    and the caches after them, and the loss. Each element within 2e-5 of
    itself and of its tensor's largest magnitude (the cached keys reach
    |20| at these scales, where fp32 rounding over two layers is ~1e-4).
    The prompt (40) is past h2o-danube's window (32): its cache is a ring
    of 32 slots, rolled at prefill and written at slots 8 and 9 by the
    decode steps."""
    ref = _reference_runs(arch)
    _, tc = _variant(arch, "float32")
    got = _port_run(tc, lm.params_from_reference(ref["params"]["float32"]),
                    ref["tokens"])
    assert set(got) == set(ref["float32"])
    for name, want in ref["float32"].items():
        assert got[name].shape == want.shape, name
        np.testing.assert_allclose(
            got[name], want, rtol=MODEL_F32_TOL,
            atol=MODEL_F32_TOL * max(1.0, float(np.abs(want).max())),
            err_msg=name)
    if tc.sliding_window:
        assert got["prefill cache k"].shape[3] == tc.sliding_window < S


@pytest.mark.parametrize("arch", DENSE + ("gelu-layernorm",))
def test_prefill_decode_and_loss_match_jax_bf16(arch):
    """The same run at the config's bf16. Where attention is nearly an
    argmax (no qk-norm: scores with std ~30 at these weight scales), bf16
    rounding flips near-ties, and a few cached values move by O(1) in
    either package against its fp32 run. So each output is held by its
    mean error against the reference's fp32 run with the same weights: at
    most twice the reference's own bf16 run's, plus 2^-8 (a scalar loss's
    error can sit below both); and the logits and loss also elementwise
    within MODEL_BF16_TOL of the reference's bf16 run."""
    ref = _reference_runs(arch)
    _, tc = _variant(arch)
    got = _port_run(tc, lm.params_from_reference(ref["params"]["bfloat16"]),
                    ref["tokens"])
    assert set(got) == set(ref["bfloat16"])
    for name, want in ref["bfloat16"].items():
        assert got[name].shape == want.shape, name
        truth = ref["float32"][name]
        err = np.abs(got[name] - truth).mean()
        ref_err = np.abs(want - truth).mean()
        assert err <= 2 * ref_err + 2 ** -8, (name, err, ref_err)
        if "cache" not in name:
            np.testing.assert_allclose(got[name], want, err_msg=name,
                                       **MODEL_BF16_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_then_decode_consistent(arch):
    """The reference's own check (tests/test_arch_smoke.py:44-87) on the
    port, at the config's dtype and the reference's tolerance: the logits
    of decoding token S after a prefill of S tokens equal those of a
    prefill over S + 1 tokens."""
    _, tc = _configs(arch)
    params = lm.init_params(tc, torch.Generator().manual_seed(1), "cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, tc.vocab_size, (2, S + 1)))
    with torch.inference_mode():
        _, caches = lm.prefill(tc, params, {"tokens": tokens[:, :S]},
                               max_len=S + 8)
        dec, _ = lm.decode_step(tc, params, tokens[:, S:], caches, S)
        full, _ = lm.prefill(tc, params, {"tokens": tokens}, max_len=S + 8)
    np.testing.assert_allclose(dec.float().numpy(), full.float().numpy(),
                               rtol=0.15, atol=0.15)


def test_set_activation_sharding_takes_only_none():
    lm.set_activation_sharding(None)
    with pytest.raises(ValueError, match="no mesh"):
        lm.set_activation_sharding(object())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_serve_on_cpu_repeats_and_matches_a_stepwise_run():
    """`serve` returns [batch, gen] tokens and two clock readings; it
    repeats for a seed, and its first token is the argmax of a prefill
    with the same weights."""
    seqs, t_pre, t_dec = tserve.serve("qwen3-4b", batch=2, prompt_len=24,
                                      gen=5, device="cpu")
    assert seqs.shape == (2, 5) and t_pre > 0 and t_dec > 0
    again, _, _ = tserve.serve("qwen3-4b", batch=2, prompt_len=24, gen=5,
                               device="cpu")
    assert torch.equal(seqs, again)
    tc = tbase.smoke_config("qwen3-4b")
    params = lm.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, tc.vocab_size, (2, 24)))
    with torch.inference_mode():
        logits, _ = lm.prefill(tc, params, {"tokens": prompt}, max_len=29)
    assert torch.equal(seqs[:, 0], logits.argmax(-1).to(seqs.dtype))


def test_serve_cli_prints_the_reference_lines():
    """`python -m repro_torch.launch.serve --arch qwen1.5-0.5b --device
    cpu` at the reference's defaults prints its two lines."""
    root = pathlib.Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-0.5b", "--device", "cpu"], cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
        capture_output=True, text=True, timeout=120, check=True)
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 2, proc.stdout
    assert re.fullmatch(
        r"\[serve\] generated \(4, 32\) tokens; prefill \d+\.\d\ds, "
        r"decode \d+\.\d\ds \(\d+\.\d ms/token/seq\)", lines[0]), lines[0]
    sample = re.fullmatch(r"\[serve\] sample: \[([\d, ]+)\]", lines[1])
    assert sample and len(sample.group(1).split(",")) == 16, lines[1]


def test_serve_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "qwen1.5-0.5b"])

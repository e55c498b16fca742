"""The causal band (the reference's sliding window) and head dim 80 in the
port's attention kernels' plain versions, against the JAX package, on the
CPU.

The CUDA kernels take a causal band `window` W (a score is kept where
0 <= q_idx - k_idx < W, the reference's `_block_mask`) and head dim 80
(h2o-danube's); their plain PyTorch versions are what a CPU tensor runs,
and chip_smoke.py holds the kernels to them on the card. Here those plain
versions are held to the reference's `layers.attention(..., window=W)` on
both of its paths: the direct one (Sq * Skv <= 2^20) and the blockwise
custom VJP (`_flash_core`, block_q 256, block_k 512). Inputs are made
with NumPy from a seed and handed to both packages.

Tolerances:
  - fp32: the forward, the lse and the gradients within rtol 1e-5 and an
    atol of 1e-5 of the largest |value| (the same sums in other orders);
  - bf16: the forward at tests/test_torch_attention.py's rtol 3e-2 /
    atol 0.15; the backward from the reference's own residuals at 2^-7 of
    the largest |value| (tests/test_torch_lm_train.py's rule: both round
    the scores and dout V^T to bf16 in the same places);
  - the atol's scale is at least 1, the inputs' (unit normals): with a
    band of 1 a gradient can be 0 up to rounding;
  - decode at head dim 80 as tests/test_torch_attention.py holds it;
  - the h2o-danube-shaped model (head dim 80, window 32, the kernel
    routes' plain versions): fp32 logits elementwise within 2e-5 of their
    largest magnitude (tests/test_torch_lm.py's MODEL_F32_TOL), fp32
    gradients each leaf within (F32_GRAD_NOISE x the reference's own
    conditioning + 2e-5) of its largest |value| (tests/test_torch_lm_
    train.py's rule: the reference's init puts attention near an argmax,
    so a leaf moves by far more than 2e-5 when every weight moves by one
    ulp); bf16 by mean error against the reference's fp32 run, at most
    twice the reference's own bf16 run's plus 2^-8 (tests/test_torch_lm.
    py's bf16 rule), and the gradients' at most 3 times (BF16_GRAD_RATIO
    of tests/test_torch_lm_train.py).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import decode_attention as decode  # noqa: E402
from repro_torch.kernels import flash_attention as flash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers, lm  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
F32 = 1e-5
BF16_FWD = dict(rtol=3e-2, atol=0.15)
BF16_BWD = 2.0 ** -7
MODEL_F32_TOL = 2e-5
F32_GRAD_NOISE = 4.0
BF16_GRAD_RATIO = 3.0
BLOCK_Q, BLOCK_K = 256, 512
# (path, S, windows): the reference's direct path (S^2 <= 2^20) and its
# blockwise custom VJP (S 2048 with 256 / 512 blocks); windows of 1, one
# inside a block, ones straddling blocks, and one past S (a no-op)
CASES = [("direct", 200, w) for w in (1, 30, 200, 4096)] + [
    ("blockwise", 2048, w) for w in (1, 200, 1000, 4096)]


def _both(arr, dtype):
    """One float32 NumPy array as a JAX array and a torch tensor of
    `dtype` (the same round-to-nearest-even to bf16 on both sides)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(arr, jdt), torch.as_tensor(arr).to(tdt)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(x, np.float32)


def _close_f32(got, want, name=""):
    want = _f32(want)
    np.testing.assert_allclose(
        _f32(got), want, rtol=F32,
        atol=F32 * max(1.0, float(np.abs(want).max())), err_msg=name)


def _inputs(path, s, d, w):
    """q, k, v, dout [1, 2, S, D] from one seed, as float32 NumPy."""
    rng = np.random.default_rng(s + d + w)
    return [rng.normal(size=(1, 2, s, d)).astype(np.float32)
            for _ in range(4)]


@functools.lru_cache(maxsize=None)
def _reference(path, s, d, w, dtype):
    """The reference's attention(causal, window=w) on `path`: its output,
    the gradients of sum(out * dout) by jax.grad, and (blockwise) the
    forward's lse and the backward from its own residuals (`_flash_fwd`,
    `_flash_bwd`). All as float32 NumPy."""
    jq, jk, jv, jdo = (_both(a, dtype)[0] for a in _inputs(path, s, d, w))
    blocks = dict(block_q=BLOCK_Q, block_k=BLOCK_K)

    def loss(q, k, v):
        out = jlayers.attention(q, k, v, causal=True, window=w, **blocks)
        return (out.astype(jnp.float32) * jdo.astype(jnp.float32)).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(jq, jk, jv)
    got = {"out": _f32(out), "grads": [_f32(g) for g in grads]}
    if path == "blockwise":
        static = (True, w, BLOCK_Q, BLOCK_K, 1.0 / float(np.sqrt(d)))
        _, res = jlayers._flash_fwd(static, jq, jk, jv)
        got["res"] = [_f32(r) for r in res]
        got["bwd"] = [_f32(g) for g in jlayers._flash_bwd(static, res, jdo)]
    return got


def _fold(x):
    return x.reshape(2, x.shape[2], x.shape[3])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("path,s,w", CASES)
def test_plain_forward_and_lse_match_the_reference(path, s, w, d, dtype):
    """`flash_attention_plain(window=w)` (and `ops.flash_attention` on a
    CPU tensor) against the reference's attention on both of its paths;
    on the blockwise one also the lse against `_flash_fwd`'s. A window of
    at least S gives the unwindowed result bit for bit."""
    ref = _reference(path, s, d, w, dtype)
    q, k, v, _ = (_both(a, dtype)[1] for a in _inputs(path, s, d, w))
    out, lse = flash.flash_attention_plain(_fold(q), _fold(k), _fold(v),
                                           window=w, return_lse=True)
    assert out.dtype == q.dtype and lse.shape == (2, s)
    assert torch.equal(out, _fold(ops.flash_attention(q, k, v, window=w)))
    want = ref["out"].reshape(2, s, d)
    if dtype == "float32":
        _close_f32(out, want, "out")
    else:
        np.testing.assert_allclose(_f32(out), want, **BF16_FWD)
    if path == "blockwise":
        lse_want = ref["res"][4].reshape(2, s)
        tol = F32 if dtype == "float32" else BF16_BWD
        np.testing.assert_allclose(lse.numpy(), lse_want, rtol=tol,
                                   atol=tol * float(np.abs(lse_want).max()))
    if w >= s:
        assert torch.equal(out, flash.flash_attention_plain(
            _fold(q), _fold(k), _fold(v)))


@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("path,s,w", CASES)
def test_plain_gradients_match_jax_grad(path, s, w, d):
    """fp32: torch.autograd.grad through `ops.flash_attention(window=w)`
    (the autograd Function, its backward `flash_attention_bwd_plain` with
    the band) against jax.grad through the reference's attention: its
    direct path's autodiff and its blockwise custom VJP."""
    ref = _reference(path, s, d, w, "float32")
    q, k, v, dout = (torch.as_tensor(a) for a in _inputs(path, s, d, w))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = ops.flash_attention(*leaves, window=w)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * dout).sum(), leaves)
    for name, g, want in zip("qkv", got, ref["grads"]):
        _close_f32(g, want, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("w", [w for p, _, w in CASES if p == "blockwise"])
def test_plain_backward_matches_flash_bwd(w, d, dtype):
    """`flash_attention_bwd_plain(window=w)` from the reference's own
    residuals (out, lse of `_flash_fwd`) against `_flash_bwd`, so only the
    backward's arithmetic is compared (the band's P = 0 outside it)."""
    s = 2048
    ref = _reference("blockwise", s, d, w, dtype)
    q, k, v, dout = (_fold(_both(a, dtype)[1])
                     for a in _inputs("blockwise", s, d, w))
    out = torch.as_tensor(ref["res"][3]).reshape(2, s, d).to(q.dtype)
    lse = torch.as_tensor(ref["res"][4]).reshape(2, s)
    got = flash.flash_attention_bwd_plain(q, k, v, out, lse, dout, window=w)
    for name, g, want in zip(("dq", "dk", "dv"), got, ref["bwd"]):
        assert g.dtype == q.dtype, name
        want = want.reshape(g.shape)
        # at least 1, the inputs' scale: with a band of 1 dq and dk are 0
        # up to rounding (P = 1 on the diagonal, so dP - delta = 0)
        scale = max(float(np.abs(want).max()), 1.0)
        tol = (dict(rtol=F32, atol=F32 * scale) if dtype == "float32"
               else dict(rtol=0, atol=BF16_BWD * scale))
        np.testing.assert_allclose(_f32(g), want, err_msg=name, **tol)


def test_window_arguments_are_checked():
    """A band is a causal call's: a negative window or one on a full call
    raises on every path; the kernels' head dims include 80; the fp32
    backward refuses a band below Sq at head dim 128."""
    q = torch.zeros(2, 16, 80)
    with pytest.raises(ValueError, match="non-causal"):
        flash.flash_attention_plain(q, q, q, causal=False, window=4)
    with pytest.raises(ValueError, match="window"):
        flash.flash_attention_plain(q, q, q, window=-1)
    with pytest.raises(ValueError, match="non-causal"):
        ops.flash_attention(q[None], q[None], q[None], causal=False,
                            window=4)
    assert flash.HEAD_DIMS == decode.HEAD_DIMS == (64, 80, 128)
    # the fp32 backward kernel takes no band below Sq at D 128 (its wrapper
    # refuses it before any device check); at or past Sq it masks nothing
    q = torch.zeros(2, 16, 128)
    lse = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="head dim 128 in float32"):
        flash.flash_attention_bwd(q, q, q, q, lse, q, window=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash.flash_attention_bwd(q, q, q, q, lse, q, window=16)


# ---- decode at head dim 80

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("valid", [1, 700, 1024])
def test_decode_head_dim_80_matches_jax(valid, dtype):
    """`ops.decode_attention` at D 80 (h2o-danube's decode over its ring)
    against the reference's decode Pallas body in interpret mode and its
    oracle, at tests/test_torch_attention.py's tolerances."""
    b, h, s, d = 2, 2, 1024, 80
    rng = np.random.default_rng(valid + d)
    arrs = [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, h, d), (b, h, s, d), (b, h, s, d))]
    (jq, q), (jk, k), (jv, v) = (_both(a, dtype) for a in arrs)
    out = ops.decode_attention(q, k, v, valid)
    assert out.shape == (b, h, d) and out.dtype == q.dtype
    tol = (dict(rtol=2e-5, atol=1e-4) if dtype == "float32"
           else dict(rtol=3e-2, atol=0.15))
    for want in (jops.decode_attention(jq, jk, jv, jnp.asarray(valid),
                                       interpret=True),
                 jref.decode_attention_ref(jq, jk, jv, valid)):
        np.testing.assert_allclose(_f32(out), _f32(want), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_plan_at_head_dim_80(dtype):
    """The kernel's tile at D 80 is the multiple of 16 slots (a group
    state's row each) nearest below 16 KB of K: 96 in bf16, 48 in fp32; the
    shared memory is the kernel's layout for it, within the H100's limit;
    the split ranges cover every n exactly once."""
    for bh, s in ((128, 4096), (1, 4096), (257, 1000)):
        plan = decode._launch_plan(bh, s, 80, dtype, 132)
        assert plan.tile == {torch.float32: 48, torch.bfloat16: 96}[dtype]
        assert plan.tile % decode.STATES == 0
        assert plan.tile * 80 * dtype.itemsize <= decode.TILE_BYTES
        assert plan.smem == decode._smem_bytes(plan.tile, plan.stages, 80,
                                               dtype.itemsize)
        assert plan.smem <= decode.SMEM_LIMIT
        assert plan.workspace == (bh * plan.n_split * 82
                                  if plan.n_split > 1 else 0)
        n = np.arange(1, s + 1)
        at = np.zeros_like(n)
        for split in range(plan.n_split):
            lo, hi = decode.split_range(n, plan.tile, plan.n_split, split)
            assert np.array_equal(lo, at)
            at = hi
        assert np.array_equal(at, n)


# ---- an h2o-danube-shaped model on the kernel routes

# h2o-danube's shape at a small size: head dim 80 (d_model 160, 2 heads,
# 1 KV head), window 32, 2 layers, vocab 256; seq 96, three windows
DANUBE = dict(num_layers=2, d_model=160, num_heads=2, num_kv_heads=1,
              d_ff=320, vocab_size=256, sliding_window=32)
B, S, MAX_LEN = 2, 96, 104


def _danube(dtype):
    jc = dataclasses.replace(jbase.smoke_config("h2o-danube-1.8b"),
                             dtype=dtype, **DANUBE)
    tc = dataclasses.replace(tbase.smoke_config("h2o-danube-1.8b"),
                             dtype=dtype, **DANUBE)
    assert tc.resolved_head_dim == 80
    return jc, tc


@pytest.fixture
def kernel_routes(monkeypatch):
    """`attention` routing as on the card, the kernels' plain versions
    standing in for the kernels (`ops.*` on a CPU tensor); each call's
    route recorded."""
    routes = []
    real_route = layers.attention_route
    real_flash, real_decode = ops.flash_attention, ops.decode_attention

    def route(*args, device="cuda", **kw):
        routes.append(real_route(*args, device="cuda", **kw))
        return routes[-1]

    def flash_cpu(q, k, v, *, causal, window=0, use_pallas):
        assert use_pallas is True
        return real_flash(q, k, v, causal=causal, window=window)

    def decode_cpu(q, k, v, valid_len, *, use_pallas):
        assert use_pallas is True
        return real_decode(q, k, v, valid_len)

    monkeypatch.setattr(layers, "attention_route", route)
    monkeypatch.setattr(layers.ops, "flash_attention", flash_cpu)
    monkeypatch.setattr(layers.ops, "decode_attention", decode_cpu)
    return routes


@functools.lru_cache(maxsize=None)
def _danube_reference():
    """The reference at the danube shape: weights (bf16, and cast to
    fp32), tokens, and per dtype the prefill logits, two decode steps'
    logits (the ring wrapped) and jax.grad of the loss."""
    jc, _ = _danube("bfloat16")
    p16 = jlm.init_params(jc, jax.random.PRNGKey(11))
    tokens = np.random.default_rng(5).integers(
        0, jc.vocab_size, (B, S + 2)).astype(np.int32)
    out = {"tokens": tokens, "params": {}}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(jc, dtype=dtype)
        params = jax.tree.map(lambda a, d=dtype: a.astype(d), p16)
        out["params"][dtype] = jax.tree.map(np.asarray, params)
        logits, caches = jlm.prefill(c, params, {"tokens": tokens[:, :S]},
                                     max_len=MAX_LEN)
        steps = [_f32(logits)]
        for t in range(2):
            logits, caches = jlm.decode_step(
                c, params, jnp.asarray(tokens[:, S + t:S + t + 1]), caches,
                jnp.asarray(S + t, jnp.int32))
            steps.append(_f32(logits))
        grad = jax.jit(jax.grad(lambda p, c=c: jlm.loss_fn(
            c, p, {"tokens": tokens[:, :S]}, remat=False)))
        out[dtype] = {"logits": np.stack(steps),
                      "grads": {k: _f32(v) for k, v in
                                _leaves("", grad(params)).items()}}
        if dtype == "float32":
            # the conditioning: the largest relative change of a leaf's
            # gradient when every weight moves by one ulp (two draws)
            cond = 0.0
            for seed in (5, 6):
                moved = _leaves("", grad(_one_ulp(params, seed)))
                for k, v in moved.items():
                    w = out[dtype]["grads"][k]
                    scale = max(float(np.abs(w).max()), 1e-30)
                    cond = max(cond, float(np.abs(_f32(v) - w).max()) / scale)
            out["conditioning"] = cond
    return out


def _one_ulp(tree, seed):
    """Every float32 weight moved by one ulp, up or down at random."""
    rng = np.random.default_rng(seed)

    def move(a):
        a = np.asarray(a, np.float32)
        to = np.where(rng.random(a.shape) < 0.5, np.inf, -np.inf)
        return jnp.asarray(np.nextafter(a, to.astype(np.float32)))

    return jax.tree.map(move, tree)


def _leaves(prefix, tree) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(f"{prefix}/{k}", v))
        return out
    return {prefix: tree}


def _port(tc, params, tokens):
    """The port's prefill, two decode steps and loss gradients (remat; a
    weight no path uses gets zeros, as jax.grad gives it)."""
    tok = torch.as_tensor(tokens)
    with torch.inference_mode():
        logits, caches = lm.prefill(tc, params, {"tokens": tok[:, :S]},
                                    max_len=MAX_LEN)
        steps = [_f32(logits)]
        for t in range(2):
            logits, caches = lm.decode_step(
                tc, params, tok[:, S + t:S + t + 1], caches,
                torch.tensor(S + t, dtype=torch.int32))
            steps.append(_f32(logits))
    live = optim.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = lm.loss_fn(tc, live, {"tokens": tok[:, :S]}, remat=True)
    grads = iter(torch.autograd.grad(loss, optim.leaves(live),
                                     materialize_grads=True))
    tree = optim.tree_map(lambda _: next(grads), live)
    return np.stack(steps), {k: _f32(g) for k, g in _leaves("", tree).items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_danube_shaped_lm_on_the_kernel_routes_matches_jax(kernel_routes,
                                                          dtype):
    """Head dim 80 and window 32 < seq 96, with the routes the card takes
    (the kernels' plain versions standing in): prefill takes the flash
    route with the band, the decode steps the decode route over the
    32-slot ring, the gradient of `loss_fn` (remat) the flash route's
    autograd Function, no call the plain route. Its prefill-then-decode
    logits and its gradients against the reference's `prefill` /
    `decode_step` and jax.grad, the weights carried across by
    `params_from_reference`."""
    ref = _danube_reference()
    _, tc = _danube(dtype)
    params = lm.params_from_reference(ref["params"][dtype])
    logits, grads = _port(tc, params, ref["tokens"])
    assert set(kernel_routes) == {"flash", "decode"}, kernel_routes
    assert kernel_routes.count("decode") == 2 * tc.num_layers
    assert set(grads) == set(ref[dtype]["grads"])
    if dtype == "float32":
        want = ref["float32"]["logits"]
        np.testing.assert_allclose(
            logits, want, rtol=MODEL_F32_TOL,
            atol=MODEL_F32_TOL * max(1.0, float(np.abs(want).max())))
        rel = F32_GRAD_NOISE * ref["conditioning"] + MODEL_F32_TOL
        for name, g in grads.items():
            want = ref["float32"]["grads"][name]
            scale = max(float(np.abs(want).max()), 1e-30)
            assert float(np.abs(g - want).max()) <= rel * scale, (
                name, float(np.abs(g - want).max()) / scale, rel)
        return
    truth = ref["float32"]["logits"]
    err = np.abs(logits - truth).mean()
    own = np.abs(ref["bfloat16"]["logits"] - truth).mean()
    assert err <= 2 * own + 2 ** -8, (err, own)
    for name, g in grads.items():
        truth = ref["float32"]["grads"][name]
        err = np.abs(g - truth).mean()
        own = np.abs(ref["bfloat16"]["grads"][name] - truth).mean()
        assert err <= BF16_GRAD_RATIO * own + 2 ** -8 * np.abs(
            truth).mean(), (name, err, own)

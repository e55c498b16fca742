"""Transformer and SSM building blocks, in PyTorch; twin of
repro/models/layers.py: the norms, RoPE and M-RoPE, grouped-query
attention, the two MLPs, the capacity-bucketed top-k MoE, and Mamba2's
chunked SSD scan, its one-token step and its causal depthwise conv.

`attention` keeps the reference's contract and routes each call by
`attention_route`, a pure function of the call's shapes and options:

  flash   the hand-written flash kernel (kernels/ops.flash_attention), for
          a causal square call from position 0 with no cache mask
          (prefill), with or without a sliding window (the kernel's band),
          or a full (non-causal) call of more than one query row with no
          mask and no window (whisper's encoder and its prefill
          cross-attention);
  decode  the hand-written decode kernel (kernels/ops.decode_attention),
          for one query row against a cache masked at `kv_valid_len`
          (a decode step), or unmasked (whisper's cross-attention at a
          decode step: valid_len is the whole cache);
  plain   the reference's own math in PyTorch: every CPU call, and the
          calls outside the kernels' contract on the card (a head dim the
          kernels do not take, a q offset, a given scale, fp16, a windowed
          non-causal or decode call).

The MoE's expert products and the SSD chunk products are plain products
in the reference too (no Pallas kernel reaches them); here they stay
`torch.matmul` / `torch.einsum`.

`ROUTES` counts the calls per route, as the kernels' `LAUNCHES` count
their launches.
"""

from __future__ import annotations

import functools
from collections import Counter
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import HEAD_DIMS

ATTENTION_ROUTES = ("flash", "decode", "plain")
# calls of `attention` per route; chip_smoke.py zeroes and reads them
ROUTES: Counter = Counter()
# the plain route walks q in chunks whose fp32 scores [B, H, rows, Skv]
# hold at most this many elements (256 MiB), where the reference switches
# to its blockwise path instead (the scores of a 32k prefill would not fit)
PLAIN_SCORE_ELEMS = 1 << 26
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * scale.float()).to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                            / head_dim))


@functools.lru_cache(maxsize=64)
def _rope_freqs_on(head_dim: int, theta: float,
                   device: torch.device) -> torch.Tensor:
    """`rope_freqs` as float32 on `device`, copied there once: a copy from
    host memory at every call would wait for the card's stream. Callers
    only read it. Made outside inference mode, so autograd may use it."""
    with torch.inference_mode(False):
        return torch.as_tensor(rope_freqs(head_dim, theta).astype(np.float32),
                               device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x [..., S, D]; positions [..., S] (broadcastable). Standard pairing:
    rotate (x[..., :D/2], x[..., D/2:])."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, float(theta), x.device)         # [D/2]
    angles = positions[..., None].float() * freqs             # [..., S, D/2]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@functools.lru_cache(maxsize=64)
def _mrope_sections_on(sections: tuple, device: torch.device) -> torch.Tensor:
    """Which position stream drives each frequency slot (the reference's
    `np.repeat(arange, sections)`), as int64 on `device`, made there once."""
    with torch.inference_mode(False):
        return torch.as_tensor(
            np.repeat(np.arange(len(sections)), sections), device=device)


def apply_mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the D/2 frequency slots are split into
    temporal/height/width sections, each rotated by its own position
    stream. x [B, H, S, D]; pos3 [3, B, S]; sum(sections) == D // 2."""
    d = x.shape[-1]
    assert sum(sections) == d // 2, (sections, d)
    freqs = _rope_freqs_on(d, float(theta), x.device)    # [half]
    sec_id = _mrope_sections_on(tuple(sections), x.device)  # [half]
    pos = pos3.index_select(0, sec_id).movedim(0, -1)    # [B, S, half]
    angles = pos.float() * freqs
    cos = torch.cos(angles)[:, None].to(x.dtype)         # [B, 1, S, half]
    sin = torch.sin(angles)[:, None].to(x.dtype)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, groups, s, d).reshape(
        b, h * groups, s, d)


def _is_zero(q_offset) -> bool:
    """Whether the query offset is known on the host to be 0. A tensor
    offset is never read back (that would sync with the card)."""
    return not isinstance(q_offset, torch.Tensor) and int(q_offset) == 0


def attention_route(
    q_shape,                 # (B, Hq, Sq, D)
    kv_shape,                # (B, Hkv, Skv, D)
    *,
    device="cuda",
    dtype: torch.dtype = torch.bfloat16,
    causal: bool = True,
    window: int = 0,
    q_offset=0,
    kv_valid_len=None,
    softmax_scale=None,
    use_pallas: bool | None = None,
) -> str:
    """The route `attention` takes for a call of these shapes and options:
    "flash", "decode" or "plain".

    Both kernels fix the scale at 1/sqrt(D), take D in HEAD_DIMS and
    float32 / bfloat16. Beyond that, flash takes
      - a causal call with Sq == Skv, no `kv_valid_len`, `q_offset` 0 and
        any window (the kernel's band: q_idx - k_idx < window; the fp32
        backward kernel refuses a band below Sq at D 128, loudly);
      - a full (non-causal) call with Sq > 1, no `kv_valid_len` and no
        window, at any Sq and Skv (the kernel's last tiles may be
        ragged);
    and decode takes Sq == 1 in a non-causal call with no window, masked
    at `kv_valid_len` or, without it, over all Skv slots. `use_pallas`:
    None takes the kernel that fits on a CUDA device and the plain math
    elsewhere; False the plain math; True the kernel, raising ValueError
    on a CPU device or a call outside both kernels' contract."""
    _, _, sq, d = q_shape
    skv = kv_shape[2]
    fits = (d in HEAD_DIMS and softmax_scale is None
            and dtype in _KERNEL_DTYPES)
    kernel = None
    if (fits and kv_valid_len is None and causal and sq == skv
            and _is_zero(q_offset)):
        kernel = "flash"
    elif (fits and kv_valid_len is None and not causal and not window
          and sq > 1):
        kernel = "flash"
    elif fits and sq == 1 and not causal and not window:
        kernel = "decode"
    cuda = torch.device(device).type == "cuda"
    if use_pallas is None:
        return kernel if cuda and kernel else "plain"
    if not use_pallas:
        return "plain"
    if not cuda:
        raise ValueError("use_pallas=True forces a CUDA kernel; got a "
                         f"tensor on {device}")
    if kernel is None:
        raise ValueError(
            f"use_pallas=True: no kernel takes q {tuple(q_shape)}, kv "
            f"{tuple(kv_shape)}, {dtype}, causal={causal}, window={window}, "
            f"q_offset={q_offset!r}, kv_valid_len "
            f"{'given' if kv_valid_len is not None else 'None'}, "
            f"softmax_scale={softmax_scale}")
    return kernel


def attention(
    q: torch.Tensor,            # [B, Hq, Sq, D]
    k: torch.Tensor,            # [B, Hkv, Skv, D]
    v: torch.Tensor,            # [B, Hkv, Skv, D]
    *,
    causal: bool = True,
    window: int = 0,            # 0 = unbounded (full attention)
    q_offset=0,                 # int or 0-d tensor: global position of q[0]
    kv_valid_len=None,          # mask out cache slots >= this (decode)
    softmax_scale=None,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Grouped-query attention, [B, Hq, Sq, D] in q's dtype, on the route
    `attention_route` picks. Both kernel routes take `_repeat_kv`'s
    expanded K/V, as the reference does; `kv_valid_len` stays on the
    device (the decode kernel reads it there), and an unmasked decode call
    reads Skv from `_all_valid_on`."""
    groups = q.shape[1] // k.shape[1]
    route = attention_route(
        q.shape, k.shape, device=q.device, dtype=q.dtype, causal=causal,
        window=window, q_offset=q_offset, kv_valid_len=kv_valid_len,
        softmax_scale=softmax_scale, use_pallas=use_pallas)
    ROUTES[route] += 1
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    if route == "flash":
        return ops.flash_attention(q, k, v, causal=causal, window=window,
                                   use_pallas=True)
    if route == "decode":
        if kv_valid_len is None:
            kv_valid_len = _all_valid_on(k.shape[2], q.device)
        return ops.decode_attention(q[:, :, 0], k, v, kv_valid_len,
                                    use_pallas=True)[:, :, None]
    return _plain_attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_valid_len=kv_valid_len,
                            softmax_scale=softmax_scale)


@functools.lru_cache(maxsize=64)
def _all_valid_on(skv: int, device: torch.device) -> torch.Tensor:
    """`skv` as one int32 on `device`, filled there once per (Skv,
    device): the decode kernel's valid_len for an unmasked call, which
    would otherwise be filled again for every layer of every step."""
    with torch.inference_mode(False):
        return torch.full((), skv, dtype=torch.int32, device=device)


def _plain_attention(q, k, v, *, causal, window, q_offset, kv_valid_len,
                     softmax_scale):
    """The reference's direct path, op for op (scores from a q-dtype
    product cast to fp32 and scaled, masked to -1e30, softmax in fp32, p
    cast to q's dtype before PV), over chunks of q rows so the fp32 scores
    never exceed PLAIN_SCORE_ELEMS. Rows are independent, so the chunks
    give the unchunked result."""
    b, h, sq, d = q.shape
    skv = k.shape[2]
    scale = (softmax_scale if softmax_scale is not None
             else 1.0 / float(np.sqrt(d)))
    k_idx = torch.arange(skv, device=q.device)
    rows = max(1, PLAIN_SCORE_ELEMS // max(b * h * skv, 1))
    outs = []
    for lo in range(0, sq, rows):
        q_blk = q[:, :, lo:lo + rows]
        scores = torch.einsum("bhqd,bhkd->bhqk", q_blk, k).float() * scale
        q_idx = q_offset + torch.arange(lo, lo + q_blk.shape[2],
                                        device=q.device)
        mask = torch.ones(q_blk.shape[2], skv, dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= q_idx[:, None] >= k_idx[None, :]
        if window:
            mask &= q_idx[:, None] - k_idx[None, :] < window
        if kv_valid_len is not None:
            mask &= k_idx[None, :] < kv_valid_len
        scores = torch.where(mask, scores, -1e30)
        p = torch.softmax(scores, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, v))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=2)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def gated_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU (llama/qwen style): w2(silu(w1 x) * w3 x)."""
    return (F.silu(x @ p["w1"]) * (x @ p["w3"])) @ p["w2"]


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """Plain GELU MLP (whisper style)."""
    return F.gelu(x @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] \
        + p["b2"]


# ---------------------------------------------------------------------------
# Mixture of Experts (top-k, capacity-bucketed grouped matmul)
# ---------------------------------------------------------------------------


def _top_k(probs: torch.Tensor, k: int):
    """`jax.lax.top_k`: the k largest along the last dim, a tie going to
    the lower index (a stable descending sort; `torch.topk` promises no
    order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _one_hot_counts(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """Per row of idx [B, K], how often each of n values occurs: [B, n] of
    `dtype`, the reference's `one_hot(idx, n).sum(axis=1)`. A comparison,
    not `F.one_hot`, which reads the indices' range back to the host."""
    ar = torch.arange(n, device=idx.device)
    return (idx[..., None] == ar).to(dtype).sum(dim=1)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`take_along_axis(t, idx[..., None], axis=1)` for t [B, N, d] and
    idx [B, M]: rows of t, [B, M, d]."""
    return torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1]))


def moe_ffn(p, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25):
    """Capacity-bucketed top-k MoE with per-sequence dispatch, op for op
    the reference's: an fp32 router and softmax, top-k renormalised, a
    stable argsort of the choices by expert and its inverse,
    position-in-expert by a boundary cummax, capacity
    C = min(max(int(cf * k * S / E), 1), S), the buckets gathered from
    the sorted layout (no scatter), grouped SwiGLU products, the
    un-dispatch through the inverse order and a sum over the k choices,
    and the Switch aux loss. x [B, S, d]; returns (out [B, S, d], aux
    fp32 scalar). Every size is a Python int: nothing is read back."""
    B, S, dm = x.shape
    E = p["w1"].shape[0]
    C = min(max(int(capacity_factor * top_k * S / E), 1), S)
    Sk = S * top_k
    dev = x.device

    logits = x.float() @ p["router"].float()                         # [B,S,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)                       # [B,S,k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = gate_idx.reshape(B, Sk)
    flat_w = gate_vals.reshape(B, Sk)
    token_of = (torch.arange(Sk, device=dev) // top_k)[None].expand(B, Sk)

    order = torch.argsort(flat_e, dim=-1, stable=True)               # [B,Sk]
    inv_order = torch.argsort(order, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(flat_w, 1, order)
    st = torch.gather(token_of, 1, order)

    iota = torch.arange(Sk, device=dev)[None]
    boundary = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=dev),
                          se[:, 1:] != se[:, :-1]], dim=-1)
    group_start = torch.cummax(torch.where(boundary, iota, 0), dim=1).values
    pos = iota - group_start
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)                    # [B,Sk]

    xg = _take(x, st)                                                # [B,Sk,d]
    # the bucket write without a scatter: expert e's entries start at
    # prefix[e] in the sorted layout, and its kept slots are the first
    # min(count, C) of them, so slot (e, c) is sorted position prefix[e] + c
    counts = _one_hot_counts(flat_e, E, torch.int64)                 # [B,E]
    prefix = torch.cumsum(counts, dim=-1) - counts
    c_iota = torch.arange(C, device=dev)[None, None]
    j = prefix[..., None] + c_iota                                   # [B,E,C]
    valid = c_iota < counts.clamp(max=C)[..., None]
    j_flat = j.reshape(B, E * C).clamp(0, Sk - 1)
    bufe = _take(xg, j_flat)
    bufe = torch.where(valid.reshape(B, E * C, 1), bufe, 0)
    bufe = bufe.reshape(B, E, C, dm)
    h = F.silu(torch.einsum("becd,edf->becf", bufe, p["w1"]))
    h = h * torch.einsum("becd,edf->becf", bufe, p["w3"])
    y = torch.einsum("becf,efd->becd", h, p["w2"]).reshape(B, E * C, dm)
    y = torch.cat([y, y.new_zeros(B, 1, dm)], dim=1)

    contrib = _take(y, slot)
    contrib = contrib * (sw * keep)[..., None].to(y.dtype)           # [B,Sk,d]
    # un-dispatch: undo the sort, then fold the k choices per token
    contrib = _take(contrib, inv_order)
    out = contrib.reshape(B, S, top_k, dm).sum(dim=2)

    # Switch-style aux loss: E * sum_e fraction_e * mean_prob_e
    frac = _one_hot_counts(flat_e, E, torch.float32) / Sk            # [B,E]
    aux = E * (frac * probs.mean(dim=1)).sum(dim=-1).mean()
    return out, aux


# ---------------------------------------------------------------------------
# Mamba2 (SSD: state-space duality, chunked scan)
# ---------------------------------------------------------------------------


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{j < t <= i} x[..., t].
    Lower-triangular; -inf above the diagonal."""
    t = x.shape[-1]
    x_cum = torch.cumsum(x, dim=-1)
    diff = x_cum[..., :, None] - x_cum[..., None, :]
    mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int = 128,
                init_state: Optional[torch.Tensor] = None):
    """Mamba2 SSD forward (Dao & Gu 2024, Listing 1) in chunked form: the
    quadratic attention-like term inside each chunk and the linear state
    recurrence across chunks, a Python loop over chunks with an fp32
    state. x [B, S, H, P], dt [B, S, H] (post-softplus), A [H] (negative),
    Bm / Cm [B, S, G, N], init_state [B, H, P, N]. Returns (y [B, S, H,
    P] in x's dtype, final state [B, H, P, N] in x's dtype)."""
    b, s, h, p_dim = x.shape
    n = Bm.shape[3]
    assert s % chunk == 0, (s, chunk)
    rep = h // Bm.shape[2]
    state = (init_state.float() if init_state is not None
             else torch.zeros(b, h, p_dim, n, dtype=torch.float32,
                              device=x.device))
    ys = []
    for lo in range(0, s, chunk):
        xci, dtci = x[:, lo:lo + chunk], dt[:, lo:lo + chunk]
        Bh = Bm[:, lo:lo + chunk].repeat_interleave(rep, dim=2)   # [b,l,h,n]
        Ch = Cm[:, lo:lo + chunk].repeat_interleave(rep, dim=2)
        dA = (dtci * A[None, None, :]).movedim(-1, 1)             # [b,h,l]
        dA_cs = torch.cumsum(dA, dim=-1)
        Lm = torch.exp(_segsum(dA))                               # [b,h,l,l]
        CB = torch.einsum("blhn,bshn->bhls", Ch, Bh)
        scores = CB * Lm
        xdt = (xci * dtci[..., None]).float()                     # [b,l,h,p]
        y_diag = torch.einsum("bhls,bshp->blhp", scores, xdt)
        decay_to_end = torch.exp(dA_cs[..., -1:] - dA_cs)         # [b,h,l]
        chunk_state = torch.einsum("blhn,bhl,blhp->bhpn", Bh.float(),
                                   decay_to_end, xdt)
        decay_in = torch.exp(dA_cs)                               # [b,h,l]
        y_off = torch.einsum("blhn,bhl,bhpn->blhp", Ch.float(), decay_in,
                             state)
        chunk_decay = torch.exp(dA_cs[..., -1])                   # [b,h]
        state = state * chunk_decay[..., None, None] + chunk_state
        ys.append((y_diag + y_off).to(x.dtype))
    return torch.cat(ys, dim=1), state.to(x.dtype)


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor):
    """One-token SSM update: h' = exp(dt A) h + dt * x B^T; y = h' C.
    x [B, H, P], dt [B, H], Bm / Cm [B, G, N], state [B, H, P, N].
    Returns (y [B, H, P] in x's dtype, new state in state's dtype)."""
    rep = state.shape[1] // Bm.shape[1]
    Bh = Bm.repeat_interleave(rep, dim=1).float()                 # [B,H,N]
    Ch = Cm.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(dt * A[None, :])[..., None, None]           # [B,H,1,1]
    add = (dt[..., None] * x.float())[..., None] * Bh[:, :, None, :]
    new_state = state.float() * decay + add
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    return y.to(x.dtype), new_state.to(state.dtype)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv, x [B, S, C], w [W, C]: the W shifted
    products summed in x's dtype in the reference's order (not
    `F.conv1d`, whose bf16 accumulation rounds otherwise). With `state`
    [B, W-1, C] it streams and returns (y, new_state)."""
    width = w.shape[0]
    if state is not None:
        full = torch.cat([state, x], dim=1)
        new_state = full[:, -(width - 1):, :]
        y = sum(full[:, i:i + x.shape[1], :] * w[i] for i in range(width))
        return y, new_state
    pad = F.pad(x, (0, 0, width - 1, 0))
    return sum(pad[:, i:i + x.shape[1], :] * w[i] for i in range(width))

"""Transformer building blocks of the dense family, in PyTorch; twin of
repro/models/layers.py.

Ported: the norms, RoPE, grouped-query attention and the two MLPs.
`apply_mrope`, `moe_ffn`, `ssd_chunked`, `ssd_decode_step` and
`causal_conv1d` come with their families' slices (ROADMAP.md, queue 1,
item 6).

`attention` keeps the reference's contract and routes each call by
`attention_route`, a pure function of the call's shapes and options:

  flash   the hand-written flash kernel (kernels/ops.flash_attention), for
          a causal square call from position 0 with no cache mask
          (prefill);
  decode  the hand-written decode kernel (kernels/ops.decode_attention),
          for one query row against a cache masked at `kv_valid_len`
          (a decode step);
  plain   the reference's own math in PyTorch: every CPU call, and the
          calls outside the kernels' contract on the card (a head dim the
          kernels do not take, a windowed prompt longer than its window).

`ROUTES` counts the calls per route, as the kernels' `LAUNCHES` count
their launches.
"""

from __future__ import annotations

import functools
from collections import Counter

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
    float32 / bfloat16. Beyond that, flash needs a causal call with
    Sq == Skv, no `kv_valid_len`, `q_offset` 0 and either no window or
    Sq <= window (then q_idx - k_idx < window holds for every unmasked
    pair, and the window is a no-op); decode needs Sq == 1, a non-causal
    call with `kv_valid_len` and no window. `use_pallas`: None takes the
    kernel that fits on a CUDA device and the plain math elsewhere; False
    the plain math; True the kernel, raising ValueError on a CPU device or
    a call outside both kernels' contract."""
    _, _, sq, d = q_shape
    skv = kv_shape[2]
    fits = (d in HEAD_DIMS and softmax_scale is None
            and dtype in _KERNEL_DTYPES)
    kernel = None
    if (fits and kv_valid_len is None and causal and sq == skv
            and _is_zero(q_offset) and (not window or sq <= window)):
        kernel = "flash"
    elif (fits and sq == 1 and not causal and kv_valid_len is not None
          and not window):
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
    device (the decode kernel reads it there)."""
    groups = q.shape[1] // k.shape[1]
    route = attention_route(
        q.shape, k.shape, device=q.device, dtype=q.dtype, causal=causal,
        window=window, q_offset=q_offset, kv_valid_len=kv_valid_len,
        softmax_scale=softmax_scale, use_pallas=use_pallas)
    ROUTES[route] += 1
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    if route == "flash":
        return ops.flash_attention(q, k, v, causal=True, use_pallas=True)
    if route == "decode":
        return ops.decode_attention(q[:, :, 0], k, v, kv_valid_len,
                                    use_pallas=True)[:, :, None]
    return _plain_attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, kv_valid_len=kv_valid_len,
                            softmax_scale=softmax_scale)


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

"""Config-driven LM assembly: init / loss / prefill / decode. Twin of
repro/models/lm.py; one code path covers all ten architectures:

  dense   pre-norm blocks: GQA attention (+bias/qk_norm/SWA) + SwiGLU
          (or LayerNorm/GELU), tied or separate unembedding
  moe     attention + capacity-bucketed top-k MoE (+ shared experts,
          + DeepSeek's dense layer 0), dispatched in 1024-token chunks
  ssm     mamba2 blocks (SSD chunked scan / streaming decode)
  hybrid  hymba: parallel attention + mamba heads in one block; windowed
          layers, with the global-attention layers interleaved
  vlm     qwen2-vl: M-RoPE, a patch-embedding prefix
  audio   whisper: an encoder stack over frame embeddings + a decoder with
          cross-attention; LayerNorm/GELU, learned positions

Parameters and caches keep the reference's layout, stacked over layers
([L, ...] leading dim), and a Python loop over layers replaces its
`lax.scan`. A cache is updated in place and returned, as the reference
returns its new cache. Attention goes through `layers.attention`, which on
the card launches the flash kernel for each prefill layer, whisper's
encoder and its prefill cross-attention, and the decode kernel for each
decode layer and whisper's cross-attention at a decode step. There is one
device and no mesh: `set_activation_sharding` accepts only None.

`loss_fn` is differentiable, with the reference's backward: its CE is an
autograd Function that keeps only the logits and the fp32 log-sum-exp
(`_SoftmaxXent`, the twin of the reference's custom-VJP `_softmax_xent`),
the flash route's attention keeps only (out, lse) and runs the backward
kernel (kernels/ops.flash_attention), and with `remat=True` (the
default, as the reference's) each decoder block is recomputed in the
backward under `torch.utils.checkpoint`, as the reference's `jax.checkpoint`
does: only the blocks' inputs are kept between the passes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = Any

# the MoE dispatch runs over chunks of this many tokens when a sequence is
# longer and divides into them, each with its own capacity
MOE_CHUNK = 1024
# rows of whisper's learned decoder positions (the reference sizes them to
# cover its decode shapes)
DEC_POS_ROWS = 65536


def set_remat_policy(name: Optional[str]) -> None:
    """The reference's remat policy hook. None, the full recompute of each
    block under `loss_fn(remat=True)`, is the only policy: the reference's
    "ssm_proj" (also keep the SSM in-projection's output) would change
    memory, not values, and is not ported."""
    if name is not None:
        raise ValueError(f"remat policy {name!r}: the port recomputes whole "
                         "blocks (None) only")


def set_activation_sharding(dp, sp=None, sp_divisor: int = 1,
                            moe_mesh=None, moe_dp_axes: tuple = ()) -> None:
    """The reference's hook for the mesh's activation shardings. The port
    runs on one device: only the reference's single-device call
    (`set_activation_sharding(None)`) is accepted."""
    if (dp is not None or sp is not None or sp_divisor != 1
            or moe_mesh is not None or moe_dp_axes):
        raise ValueError("set_activation_sharding: the port runs on one "
                         "device and has no mesh; pass None")


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, dtype, device,
                scale: Optional[float] = None) -> torch.Tensor:
    """Normal draws in fp32 times 1/sqrt(fan_in) (or `scale`), cast to
    `dtype`: the reference's distribution, from a torch stream. fan_in is
    the first dim, as the reference takes it: for a stacked [L, in, out]
    weight that is L. Drawn on the generator's device, then placed on
    `device`."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    draw = torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)
    return draw.mul_(s).to(device=device, dtype=dtype)


def _attn_block_params(gen, cfg: ArchConfig, n_layers: int, dt, device):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        "wq": _dense_init(gen, (n_layers, d, hq * hd), dt, device),
        "wk": _dense_init(gen, (n_layers, d, hkv * hd), dt, device),
        "wv": _dense_init(gen, (n_layers, d, hkv * hd), dt, device),
        "wo": _dense_init(gen, (n_layers, hq * hd, d), dt, device),
        "ln1": torch.ones(n_layers, d, **f32),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(n_layers, hq * hd, dtype=dt, device=device)
        p["bk"] = torch.zeros(n_layers, hkv * hd, dtype=dt, device=device)
        p["bv"] = torch.zeros(n_layers, hkv * hd, dtype=dt, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(n_layers, hd, **f32)
        p["k_norm"] = torch.ones(n_layers, hd, **f32)
    if cfg.norm == "layernorm":
        p["ln1_b"] = torch.zeros(n_layers, d, **f32)
    return p


def _mlp_block_params(gen, cfg: ArchConfig, n_layers: int, dt, device):
    d, f = cfg.d_model, cfg.d_ff
    f32 = dict(dtype=torch.float32, device=device)
    if cfg.moe:
        E, fe = cfg.num_experts, cfg.d_ff
        p = {
            "router": _dense_init(gen, (n_layers, d, E), torch.float32,
                                  device),
            "w1": _dense_init(gen, (n_layers, E, d, fe), dt, device),
            "w3": _dense_init(gen, (n_layers, E, d, fe), dt, device),
            "w2": _dense_init(gen, (n_layers, E, fe, d), dt, device),
            "ln2": torch.ones(n_layers, d, **f32),
        }
        if cfg.num_shared_experts:
            fs = cfg.num_shared_experts * cfg.d_ff
            p["shared_w1"] = _dense_init(gen, (n_layers, d, fs), dt, device)
            p["shared_w3"] = _dense_init(gen, (n_layers, d, fs), dt, device)
            p["shared_w2"] = _dense_init(gen, (n_layers, fs, d), dt, device)
        return p
    if cfg.mlp == "gelu":
        return {
            "w1": _dense_init(gen, (n_layers, d, f), dt, device),
            "b1": torch.zeros(n_layers, f, dtype=dt, device=device),
            "w2": _dense_init(gen, (n_layers, f, d), dt, device),
            "b2": torch.zeros(n_layers, d, dtype=dt, device=device),
            "ln2": torch.ones(n_layers, d, **f32),
            "ln2_b": torch.zeros(n_layers, d, **f32),
        }
    return {
        "w1": _dense_init(gen, (n_layers, d, f), dt, device),
        "w3": _dense_init(gen, (n_layers, d, f), dt, device),
        "w2": _dense_init(gen, (n_layers, f, d), dt, device),
        "ln2": torch.ones(n_layers, d, **f32),
    }


def _ssm_block_params(gen, cfg: ArchConfig, n_layers: int, dt, device):
    d = cfg.d_model
    din = cfg.ssm_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = din + 2 * g * n
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": _dense_init(gen, (n_layers, d, 2 * din + 2 * g * n + h),
                               dt, device),
        "conv_w": _dense_init(gen, (n_layers, cfg.conv_width, conv_dim), dt,
                              device, scale=0.5),
        "dt_bias": torch.zeros(n_layers, h, **f32),
        "a_log": torch.zeros(n_layers, h, **f32),  # A = -exp(a_log) = -1
        "d_skip": torch.ones(n_layers, h, **f32),
        "ssm_norm": torch.ones(n_layers, din, **f32),
        "out_proj": _dense_init(gen, (n_layers, din, d), dt, device),
        "ln_ssm": torch.ones(n_layers, d, **f32),
    }


def _block_group_params(gen, cfg: ArchConfig, n_layers: int, device):
    """Params for a stack of `n_layers` homogeneous blocks."""
    dt = _dtype(cfg)
    p: dict = {}
    if cfg.num_heads:
        p.update(_attn_block_params(gen, cfg, n_layers, dt, device))
    if cfg.ssm:
        p.update(_ssm_block_params(gen, cfg, n_layers, dt, device))
    if cfg.d_ff or cfg.moe:
        p.update(_mlp_block_params(gen, cfg, n_layers, dt, device))
    return p


def _n_main(cfg: ArchConfig) -> int:
    """Layers in the `blocks` stack: all but the hybrid's global layers and
    DeepSeek's dense layer 0."""
    if cfg.hybrid and cfg.num_global_layers:
        return cfg.num_layers - cfg.num_global_layers
    if cfg.first_layer_dense:
        return cfg.num_layers - 1
    return cfg.num_layers


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random weights on `device`, drawn from `generator` (on its own
    device) with the reference's distributions: normal times
    1/sqrt(fan_in), the embeddings and learned positions at 0.02, norms in
    fp32. The reference draws JAX's stream, which torch cannot;
    `params_from_reference` carries its weights across instead."""
    dt = _dtype(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    params: dict = {
        "embed": _dense_init(generator, (cfg.vocab_size, cfg.d_model), dt,
                             device, scale=0.02),
        "final_norm": torch.ones(cfg.d_model, **f32),
    }
    if cfg.norm == "layernorm":
        params["final_norm_b"] = torch.zeros(cfg.d_model, **f32)
    if not cfg.tie_embeddings:
        params["unembed"] = _dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dt, device)

    if cfg.encoder_decoder:
        d, hd = cfg.d_model, cfg.resolved_head_dim
        hq, hkv, nl = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
        params["enc_pos"] = _dense_init(generator, (cfg.encoder_seq, d), dt,
                                        device, scale=0.02)
        params["enc_blocks"] = _block_group_params(
            generator, cfg, cfg.encoder_layers, device)
        params["enc_final_norm"] = torch.ones(d, **f32)
        params["enc_final_norm_b"] = torch.zeros(d, **f32)
        # the decoder's cross-attention stack
        params["cross"] = {
            "wq": _dense_init(generator, (nl, d, hq * hd), dt, device),
            "wk": _dense_init(generator, (nl, d, hkv * hd), dt, device),
            "wv": _dense_init(generator, (nl, d, hkv * hd), dt, device),
            "wo": _dense_init(generator, (nl, hq * hd, d), dt, device),
            "ln": torch.ones(nl, d, **f32),
            "ln_b": torch.zeros(nl, d, **f32),
        }
        # whisper's decoder takes learned positions, no RoPE
        params["dec_pos"] = _dense_init(generator, (DEC_POS_ROWS, d), dt,
                                        device, scale=0.02)

    if cfg.hybrid and cfg.num_global_layers:
        params["global_blocks"] = _block_group_params(
            generator, cfg, cfg.num_global_layers, device)
    if cfg.first_layer_dense:
        dense_cfg = dataclasses.replace(
            cfg, moe=False, d_ff=cfg.dense_d_ff, name=cfg.name + "-dense0")
        params["dense0"] = _block_group_params(generator, dense_cfg, 1,
                                               device)
    params["blocks"] = _block_group_params(generator, cfg, _n_main(cfg),
                                           device)
    return params


def params_from_reference(tree, device="cpu") -> Params:
    """The JAX package's parameter tree, as NumPy arrays (nested dicts),
    as the port's tensors on `device`. A bf16 leaf arrives as an
    ml_dtypes bfloat16 array, which torch cannot wrap: it goes through
    fp32 and back, which is exact."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


# ---------------------------------------------------------------------------
# block forwards (one layer, unstacked params)
# ---------------------------------------------------------------------------


def _norm(cfg, x, scale, bias=None):
    if cfg.norm == "layernorm":
        return L.layernorm(x, scale,
                           bias if bias is not None else torch.zeros_like(scale))
    return L.rmsnorm(x, scale)


def _attn_forward(cfg: ArchConfig, p, x, *, positions, pos3=None, window,
                  cache=None, cache_index=None, cross_kv=None, causal=True,
                  use_pallas=None):
    """Attention sub-block. With `cross_kv` it attends (full) to the
    encoder's K/V; with `cache` (one layer's {"k", "v"}, views of the
    stacked cache) it writes this call's K/V there in place: a decode step
    its slot, a prefill the prompt."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, s, hq, hd).transpose(1, 2)

    if cross_kv is not None:
        k, v = cross_kv
        out = L.attention(q, k, v, causal=False, use_pallas=use_pallas)
        return out.transpose(1, 2).reshape(b, s, hq * hd) @ p["wo"]

    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k = k + p["bk"]
        v = v + p["bv"]
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"])
        k = L.rmsnorm(k, p["k_norm"])
    if cfg.mrope and pos3 is not None:
        q = L.apply_mrope(q, pos3, cfg.rope_theta, cfg.mrope_sections)
        k = L.apply_mrope(k, pos3, cfg.rope_theta, cfg.mrope_sections)
    elif not cfg.encoder_decoder:
        # (whisper's learned positions are added at the embedding instead)
        q = L.apply_rope(q, positions[:, None, :], cfg.rope_theta)
        k = L.apply_rope(k, positions[:, None, :], cfg.rope_theta)

    if cache is not None and s == 1:
        # decode: write slot (ring-buffered when windowed); clamped as the
        # reference's dynamic_update_slice clamps its start
        ck, cv = cache["k"], cache["v"]
        cache_len = ck.shape[2]
        slot = (cache_index % cache_len if window
                else cache_index.clamp(max=cache_len - 1))
        slot = slot.reshape(1).long()
        ck.index_copy_(2, slot, k)
        cv.index_copy_(2, slot, v)
        valid = (cache_index + 1).clamp(max=cache_len)
        out = L.attention(q, ck, cv, causal=False, kv_valid_len=valid,
                          use_pallas=use_pallas)
    else:
        if cache is not None:
            # prefill: bulk write. Windowed caches keep the tail, laid out
            # in ring order (token position p -> slot p % W) so decode
            # appends consistently.
            cache_len = cache["k"].shape[2]
            for name, t in (("k", k), ("v", v)):
                if window and cache_len < s:
                    t = torch.roll(t[:, :, -cache_len:], s % cache_len,
                                   dims=2)
                cache[name][:, :, :t.shape[2]] = t
        out = L.attention(q, k, v, causal=causal, window=window,
                          use_pallas=use_pallas)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return out @ p["wo"]


def _mlp_forward(cfg: ArchConfig, p, x):
    """Dense or MoE FFN on [B, S, d]. Returns (out, aux loss). The MoE
    branch keys on the params (DeepSeek's dense layer 0 runs with the MoE
    config). A sequence longer than MOE_CHUNK that divides into chunks is
    dispatched chunk by chunk, each with its own capacity, and its aux
    loss is the chunks' mean."""
    if cfg.moe and "router" in p:
        moe_p = {k: p[k] for k in ("router", "w1", "w3", "w2")}
        kw = dict(top_k=cfg.experts_per_token,
                  capacity_factor=cfg.moe_capacity_factor)
        s = x.shape[1]
        if s > MOE_CHUNK and s % MOE_CHUNK == 0:
            outs, aux = [], 0.0
            for lo in range(0, s, MOE_CHUNK):
                o, a = L.moe_ffn(moe_p, x[:, lo:lo + MOE_CHUNK], **kw)
                outs.append(o)
                aux = aux + a
            out, aux = torch.cat(outs, dim=1), aux / (s // MOE_CHUNK)
        else:
            out, aux = L.moe_ffn(moe_p, x, **kw)
        if "shared_w1" in p:
            shared = F.silu(x @ p["shared_w1"]) * (x @ p["shared_w3"])
            out = out + shared @ p["shared_w2"]
        return out, aux
    if cfg.mlp == "gelu":
        return L.gelu_mlp(p, x), 0.0
    return L.gated_mlp(p, x), 0.0


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus`: log(1 + e^x) as logaddexp(x, 0), with no
    threshold (F.softplus returns x past 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssm_forward(cfg: ArchConfig, p, x, *, cache=None):
    """Mamba2 sub-block on [B, S, d]. With `cache` (one layer's {"conv",
    "ssm"}, views of the stacked cache) a prefill writes the conv state
    (captured from zeros) and the final SSM state there, a decode step
    (S == 1) streams from them and writes them back, in place."""
    b, s, d = x.shape
    din = cfg.ssm_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    pdim = cfg.ssm_head_dim
    proj = x @ p["in_proj"]  # [b, s, 2*din + 2*g*n + h]
    z, xb, dt_raw = proj.split([din, din + 2 * g * n, h], dim=-1)
    A = -torch.exp(p["a_log"])
    dt = _softplus(dt_raw.float() + p["dt_bias"])  # [b, s, h]

    if cache is None or s > 1:
        if cache is not None:  # prefill, capturing the conv state
            conv_out, conv_state = L.causal_conv1d(
                xb, p["conv_w"],
                state=x.new_zeros(b, cfg.conv_width - 1, xb.shape[-1]))
        else:
            conv_out = L.causal_conv1d(xb, p["conv_w"])
        conv_out = F.silu(conv_out)
        xs, B_, C_ = conv_out.split([din, g * n, g * n], dim=-1)
        xs = xs.reshape(b, s, h, pdim)
        chunk = 128
        while s % chunk:
            chunk //= 2
        y, final_state = L.ssd_chunked(xs, dt, A, B_.reshape(b, s, g, n),
                                       C_.reshape(b, s, g, n), chunk=chunk)
        y = (y + xs * p["d_skip"][None, None, :, None]).to(x.dtype)
        y = y.reshape(b, s, din)
        if cache is not None:
            cache["conv"].copy_(conv_state)
            cache["ssm"].copy_(final_state)
    else:
        conv_out, conv_state = L.causal_conv1d(xb, p["conv_w"],
                                               state=cache["conv"])
        conv_out = F.silu(conv_out)
        xs, B_, C_ = conv_out[:, 0].split([din, g * n, g * n], dim=-1)
        xs = xs.reshape(b, h, pdim)
        y, new_state = L.ssd_decode_step(
            xs, dt[:, 0], A, B_.reshape(b, g, n), C_.reshape(b, g, n),
            cache["ssm"])
        y = (y + xs * p["d_skip"][None, :, None]).to(x.dtype)
        y = y.reshape(b, 1, din)
        cache["conv"].copy_(conv_state)
        cache["ssm"].copy_(new_state)

    y = L.rmsnorm(y, p["ssm_norm"]) * F.silu(z)
    return y @ p["out_proj"]


def block_forward(cfg: ArchConfig, p, x, *, positions, pos3=None, window,
                  cache=None, cache_index=None, cross_kv=None,
                  use_pallas=None):
    """One decoder block; `cache` ({"attn": {"k", "v"}} and / or
    {"ssm_c": {"conv", "ssm"}}) is written in place. Returns (x, aux
    loss): the MoE's, else 0.0."""
    aux = 0.0
    attn = dict(positions=positions, pos3=pos3, window=window,
                cache_index=cache_index, use_pallas=use_pallas)
    if cfg.hybrid:
        # hymba: attention and mamba heads in parallel on one normed input
        h = _norm(cfg, x, p["ln1"])
        attn_out = _attn_forward(
            cfg, p, h, cache=None if cache is None else cache["attn"], **attn)
        ssm_out = _ssm_forward(
            cfg, p, h, cache=None if cache is None else cache["ssm_c"])
        x = x + 0.5 * (attn_out + ssm_out)
    elif cfg.ssm:
        h = _norm(cfg, x, p["ln_ssm"])
        x = x + _ssm_forward(
            cfg, p, h, cache=None if cache is None else cache["ssm_c"])
    else:
        h = _norm(cfg, x, p["ln1"], p.get("ln1_b"))
        x = x + _attn_forward(
            cfg, p, h, cache=None if cache is None else cache["attn"], **attn)

    if cross_kv is not None:
        pc = p["cross"]
        h = L.layernorm(x, pc["ln"], pc["ln_b"])
        x = x + _attn_forward(
            cfg, {"wq": pc["wq"], "wo": pc["wo"]}, h, positions=positions,
            window=0, cross_kv=cross_kv, use_pallas=use_pallas)

    if cfg.d_ff or cfg.moe:
        h = _norm(cfg, x, p["ln2"], p.get("ln2_b"))
        out, aux = _mlp_forward(cfg, p, h)
        x = x + out
    return x, aux


# ---------------------------------------------------------------------------
# the layer loop
# ---------------------------------------------------------------------------


def _layer_of(tree, i):
    return {k: (_layer_of(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _run_group(cfg: ArchConfig, stacked, x, layers, *, caches, window,
               enc_out=None, remat=False, **kw):
    """Blocks `layers` (a range) of a stacked group, each with its slice of
    the stacked caches (written in place). Whisper's cross-attention K/V
    come from `enc_out` (computed per layer; a prefill also writes them to
    the cache's `cross_k` / `cross_v`) or, at a decode step, from the
    cache. With `remat` (no caches) each block runs under a non-reentrant
    `checkpoint`: its activations are recomputed in the backward, as the
    reference's `jax.checkpoint` of the block. Returns (x, summed aux)."""
    aux_sum = 0.0
    for i in layers:
        p = _layer_of(stacked, i)
        c = None if caches is None else _layer_of(caches, i)
        cross_kv = None
        if enc_out is not None:
            pc = p["cross"]
            b, se, _ = enc_out.shape
            shape = (b, se, cfg.num_kv_heads, cfg.resolved_head_dim)
            cross_kv = ((enc_out @ pc["wk"]).reshape(shape).transpose(1, 2),
                        (enc_out @ pc["wv"]).reshape(shape).transpose(1, 2))
            if c is not None:
                c["cross_k"].copy_(cross_kv[0])
                c["cross_v"].copy_(cross_kv[1])
        elif c is not None and "cross_k" in c:
            cross_kv = (c["cross_k"], c["cross_v"])
        block_cache = None
        if c is not None:
            block_cache = {k: v for k, v in c.items()
                           if not k.startswith("cross_")} or None
        if remat and caches is None:
            x, aux = checkpoint(block_forward, cfg, p, x, window=window,
                                cross_kv=cross_kv, use_reentrant=False, **kw)
        else:
            x, aux = block_forward(cfg, p, x, window=window,
                                   cache=block_cache, cross_kv=cross_kv, **kw)
        aux_sum = aux_sum + aux
    return x, aux_sum


def _run_decoder_stack(cfg: ArchConfig, params, x, *, positions, pos3=None,
                       caches=None, cache_index=None, enc_out=None,
                       use_pallas=None, remat=False):
    """The arch's block groups in order: DeepSeek's dense layer 0, then
    either hymba's interleave (global 0, the first n_main // 2 windowed
    layers, global 1, the rest, global 2) or the one `blocks` stack; each
    block recomputed in the backward with `remat`. Returns (x, aux)."""
    kw = dict(positions=positions, pos3=pos3, cache_index=cache_index,
              use_pallas=use_pallas, remat=remat)
    group_caches = (lambda name: None if caches is None  # noqa: E731
                    else caches[name])
    aux_total = 0.0
    if cfg.first_layer_dense:
        x, aux = _run_group(cfg, params["dense0"], x, range(1),
                            caches=group_caches("dense0"),
                            window=cfg.sliding_window, **kw)
        aux_total = aux_total + aux

    n_main = _n_main(cfg)
    if cfg.hybrid and cfg.num_global_layers:
        h1 = n_main // 2
        segments = [range(0, h1), range(h1, n_main)]
        for gi in range(cfg.num_global_layers):
            x, aux = _run_group(cfg, params["global_blocks"], x,
                                range(gi, gi + 1),
                                caches=group_caches("global_blocks"),
                                window=0, **kw)  # global attention
            aux_total = aux_total + aux
            if gi < len(segments):
                x, aux = _run_group(cfg, params["blocks"], x, segments[gi],
                                    caches=group_caches("blocks"),
                                    window=cfg.sliding_window, **kw)
                aux_total = aux_total + aux
    else:
        stacked = params["blocks"]
        if cfg.encoder_decoder:
            # the cross-attention params ride along in the layer loop
            stacked = {**stacked, "cross": params["cross"]}
        x, aux = _run_group(cfg, stacked, x, range(n_main),
                            caches=group_caches("blocks"),
                            window=cfg.sliding_window, enc_out=enc_out, **kw)
        aux_total = aux_total + aux
    return x, aux_total


def _encode(cfg: ArchConfig, params, frames, use_pallas=None):
    """Whisper's encoder on frame embeddings [B, S_enc, d]: learned
    positions, LayerNorm / GELU blocks, full (non-causal) attention."""
    x = frames + params["enc_pos"][None, :frames.shape[1]]
    b, se = frames.shape[:2]
    positions = torch.arange(se, device=x.device).expand(b, se)
    stacked = params["enc_blocks"]
    for i in range(cfg.encoder_layers):
        p = _layer_of(stacked, i)
        hn = L.layernorm(x, p["ln1"], p.get("ln1_b",
                                            torch.zeros_like(p["ln1"])))
        x = x + _attn_forward(cfg, p, hn, positions=positions, window=0,
                              causal=False, use_pallas=use_pallas)
        hn = L.layernorm(x, p["ln2"], p["ln2_b"])
        x = x + L.gelu_mlp(p, hn)
    return L.layernorm(x, params["enc_final_norm"],
                       params["enc_final_norm_b"])


def _dec_pos(table: torch.Tensor, start, s: int) -> torch.Tensor:
    """Rows [start, start + s) of the learned decoder positions, the start
    clamped to [0, rows - s] as the reference's dynamic_slice clamps it. A
    tensor start stays on the device."""
    hi = table.shape[0] - s
    if isinstance(start, torch.Tensor):
        idx = (start.long().clamp(0, hi)
               + torch.arange(s, device=table.device))
        return table.index_select(0, idx.reshape(s))
    start = min(max(int(start), 0), hi)
    return table[start:start + s]


def _embed_inputs(cfg: ArchConfig, params, batch):
    """Token embedding, with the VLM's patch prefix before the tokens and
    whisper's learned positions from `pos_offset`. Returns (x, positions,
    pos3)."""
    tokens = batch["tokens"]
    b, s_tok = tokens.shape
    x = params["embed"][tokens]
    pos3 = batch.get("pos3")
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    if cfg.encoder_decoder:
        x = x + _dec_pos(params["dec_pos"], batch.get("pos_offset", 0),
                         s_tok)[None]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device).expand(
            b, x.shape[1])
    return x, positions, pos3


def _logits(cfg: ArchConfig, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["unembed"]


class _SoftmaxXent(torch.autograd.Function):
    """Per-token CE, the twin of the reference's memory-saving custom-VJP
    `_softmax_xent`. Forward: fp32 log-sum-exp with the max taken out,
    minus the target's logit; it keeps only the logits (in their dtype)
    and the fp32 lse. Backward: (softmax - onehot) * g, the softmax
    rebuilt from them, cast to the logits' dtype (`_softmax_xent_bwd`)."""

    @staticmethod
    def forward(ctx, logits, targets):
        l32 = logits.float()
        mx = l32.amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(l32 - mx).sum(dim=-1)) + mx[..., 0]
        picked = l32.gather(-1, targets[..., None].long())[..., 0]
        ctx.save_for_backward(logits, targets, lse)
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        d = torch.exp(logits.float() - lse[..., None])
        # minus the one-hot: each row's target entry, one writer each
        flat = d.view(-1, d.shape[-1])
        rows = torch.arange(flat.shape[0], device=d.device)
        flat[rows, targets.reshape(-1).long()] -= 1.0
        return d.mul_(g[..., None]).to(logits.dtype), None


def _softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token CE [B, S] of logits [B, S, V] against targets [B, S]."""
    return _SoftmaxXent.apply(logits, targets)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def loss_fn(cfg: ArchConfig, params, batch, *, remat: bool = True,
            use_pallas=None):
    """Next-token CE + 0.01 x the MoE aux loss, differentiable (see the
    module's docstring); `remat` recomputes each decoder block in the
    backward (the reference's default). batch: tokens [B, S] (+ pos3 /
    patch_embeds / frames). The VLM's patch prefix is left out of the
    loss. `use_pallas` reaches every attention call (None: the kernels on
    the card)."""
    x, positions, pos3 = _embed_inputs(cfg, params, batch)
    enc_out = None
    if cfg.encoder_decoder:
        enc_out = _encode(cfg, params, batch["frames"], use_pallas)
    x, aux = _run_decoder_stack(cfg, params, x, positions=positions,
                                pos3=pos3, enc_out=enc_out,
                                use_pallas=use_pallas, remat=remat)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))
    tokens = batch["tokens"]
    if cfg.family == "vlm" and "patch_embeds" in batch:
        x = x[:, batch["patch_embeds"].shape[1]:]
    logits = _logits(cfg, params, x[:, :-1])
    return _softmax_xent(logits, tokens[:, 1:]).mean() + 0.01 * aux


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, *,
               device):
    """Stacked decode caches sized for `max_len` (ring-buffered for SWA),
    zeros of the config's dtype on `device`: attention K/V, the SSM's conv
    and scan states, whisper's cross K/V."""
    dt = _dtype(cfg)
    hd = cfg.resolved_head_dim
    hkv = cfg.num_kv_heads
    zeros = lambda *shape: torch.zeros(shape, dtype=dt,  # noqa: E731
                                       device=device)

    def attn_cache(n_layers, window):
        clen = min(window, max_len) if window else max_len
        return {"k": zeros(n_layers, batch_size, hkv, clen, hd),
                "v": zeros(n_layers, batch_size, hkv, clen, hd)}

    def ssm_cache(n_layers):
        conv_dim = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
        return {"conv": zeros(n_layers, batch_size, cfg.conv_width - 1,
                              conv_dim),
                "ssm": zeros(n_layers, batch_size, cfg.ssm_heads,
                             cfg.ssm_head_dim, cfg.ssm_state)}

    caches: dict = {}
    n_main = _n_main(cfg)
    if cfg.first_layer_dense:
        caches["dense0"] = {"attn": attn_cache(1, cfg.sliding_window)}
    if cfg.hybrid and cfg.num_global_layers:
        ng = cfg.num_global_layers
        caches["global_blocks"] = {"attn": attn_cache(ng, 0),
                                   "ssm_c": ssm_cache(ng)}
        caches["blocks"] = {"attn": attn_cache(n_main, cfg.sliding_window),
                            "ssm_c": ssm_cache(n_main)}
        return caches
    if cfg.ssm and not cfg.hybrid:
        caches["blocks"] = {"ssm_c": ssm_cache(n_main)}
        return caches
    blocks: dict = {"attn": attn_cache(n_main, cfg.sliding_window)}
    if cfg.encoder_decoder:
        blocks["cross_k"] = zeros(n_main, batch_size, hkv, cfg.encoder_seq,
                                  hd)
        blocks["cross_v"] = torch.zeros_like(blocks["cross_k"])
    caches["blocks"] = blocks
    return caches


def prefill(cfg: ArchConfig, params, batch, max_len: Optional[int] = None,
            *, use_pallas=None):
    """Forward over a prompt, producing (last-token logits, filled caches).
    `use_pallas` reaches every attention call (None: the kernels on the
    card)."""
    x, positions, pos3 = _embed_inputs(cfg, params, batch)
    b, s = x.shape[0], x.shape[1]
    enc_out = None
    if cfg.encoder_decoder:
        enc_out = _encode(cfg, params, batch["frames"], use_pallas)
    caches = init_cache(cfg, b, max_len or s, device=x.device)
    cache_index = torch.zeros((), dtype=torch.int32, device=x.device)
    x, _ = _run_decoder_stack(
        cfg, params, x, positions=positions, pos3=pos3, caches=caches,
        cache_index=cache_index, enc_out=enc_out, use_pallas=use_pallas)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))
    logits = _logits(cfg, params, x[:, -1:])
    return logits[:, 0], caches


def decode_step(cfg: ArchConfig, params, tokens, caches, cache_index, *,
                pos3=None, use_pallas=None):
    """One greedy-decode step. tokens [B, 1]; cache_index: 0-d int32 tensor
    on the params' device (or an int) — number of tokens already in the
    cache; pos3 [3, B, 1] (VLM). Returns (logits [B, V], caches), the
    caches written in place. Nothing here reads a device value back to the
    host."""
    b = tokens.shape[0]
    device = params["embed"].device
    cache_index = torch.as_tensor(cache_index, dtype=torch.int32,
                                  device=device)
    batch = {"tokens": tokens,
             "positions": cache_index.reshape(1, 1).expand(b, 1),
             "pos_offset": cache_index}
    if pos3 is not None:
        batch["pos3"] = pos3
    x, positions, pos3 = _embed_inputs(cfg, params, batch)
    x, _ = _run_decoder_stack(
        cfg, params, x, positions=positions, pos3=pos3, caches=caches,
        cache_index=cache_index, use_pallas=use_pallas)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))
    return _logits(cfg, params, x)[:, 0], caches

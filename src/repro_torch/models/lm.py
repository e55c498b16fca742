"""Config-driven LM assembly, the dense family: init / loss / prefill /
decode. Twin of repro/models/lm.py.

  dense   pre-norm blocks: GQA attention (+bias/qk_norm/SWA) + SwiGLU
          (or LayerNorm/GELU), tied or separate unembedding

The other families (moe, ssm, hybrid, vlm, audio) come in later slices,
each a path of its own (ROADMAP.md, queue 1, item 6); the entry points
refuse their configs with NotImplementedError.

Parameters and caches keep the reference's layout, stacked over layers
([L, ...] leading dim), and a Python loop over layers replaces its
`lax.scan`. A cache is updated in place and returned, as the reference
returns its new cache. Attention goes through `layers.attention`, which
launches the flash kernel for each prefill layer and the decode kernel for
each decode layer on the card. There is one device and no mesh:
`set_activation_sharding` accepts only None.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

Params = Any

# the slice of ROADMAP.md (queue 1, item 6) that brings each family
FAMILY_SLICES = {
    "vlm": "VLM (apply_mrope, the patch prefix)",
    "audio": "audio (whisper: the encoder, cross-attention, learned "
             "positions)",
    "moe": "MoE (moe_ffn, DeepSeek's dense layer 0)",
    "ssm": "SSM (ssd_chunked, ssd_decode_step, causal_conv1d)",
    "hybrid": "hybrid (hymba)",
}


def _require_dense(cfg: ArchConfig, what: str) -> None:
    if cfg.family != "dense":
        slice_ = FAMILY_SLICES.get(cfg.family, cfg.family)
        raise NotImplementedError(
            f"{what}: {cfg.name} is of the {cfg.family!r} family, which the "
            "port does not run yet; ROADMAP.md, queue 1, item 6 brings it "
            f"in the {slice_} slice")


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


def _block_group_params(gen, cfg: ArchConfig, n_layers: int, device):
    """Params for a stack of `n_layers` homogeneous dense blocks."""
    dt = _dtype(cfg)
    p: dict = {}
    if cfg.num_heads:
        p.update(_attn_block_params(gen, cfg, n_layers, dt, device))
    if cfg.d_ff:
        p.update(_mlp_block_params(gen, cfg, n_layers, dt, device))
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random weights on `device`, drawn from `generator` (on its own
    device) with the reference's distributions: normal times
    1/sqrt(fan_in), the embedding at 0.02, norms in fp32. The reference
    draws JAX's stream, which torch cannot; `params_from_reference` carries
    its weights across instead."""
    _require_dense(cfg, "init_params")
    dt = _dtype(cfg)
    params: dict = {
        "embed": _dense_init(generator, (cfg.vocab_size, cfg.d_model), dt,
                             device, scale=0.02),
        "final_norm": torch.ones(cfg.d_model, dtype=torch.float32,
                                 device=device),
    }
    if cfg.norm == "layernorm":
        params["final_norm_b"] = torch.zeros(cfg.d_model, dtype=torch.float32,
                                             device=device)
    if not cfg.tie_embeddings:
        params["unembed"] = _dense_init(
            generator, (cfg.d_model, cfg.vocab_size), dt, device)
    params["blocks"] = _block_group_params(generator, cfg, cfg.num_layers,
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


def _attn_forward(cfg: ArchConfig, p, x, *, positions, window, cache=None,
                  cache_index=None, use_pallas=None):
    """Causal self-attention sub-block. With `cache` (one layer's {"k",
    "v"}, views of the stacked cache) it writes this call's K/V there in
    place: a decode step its slot, a prefill the prompt."""
    b, s, d = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(b, s, hq, hd).transpose(1, 2)
    k = k.reshape(b, s, hkv, hd).transpose(1, 2)
    v = v.reshape(b, s, hkv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = L.rmsnorm(q, p["q_norm"])
        k = L.rmsnorm(k, p["k_norm"])
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
        out = L.attention(q, k, v, causal=True, window=window,
                          use_pallas=use_pallas)
    out = out.transpose(1, 2).reshape(b, s, hq * hd)
    return out @ p["wo"]


def _mlp_forward(cfg: ArchConfig, p, x):
    """Dense FFN on [B, S, d]."""
    if cfg.mlp == "gelu":
        return L.gelu_mlp(p, x)
    return L.gated_mlp(p, x)


def block_forward(cfg: ArchConfig, p, x, *, positions, window, cache=None,
                  cache_index=None, use_pallas=None):
    """One dense decoder block; `cache` ({"attn": {"k", "v"}}) is written
    in place. The reference's MoE aux loss is 0 for a dense block, so no
    block returns one."""
    h = _norm(cfg, x, p["ln1"], p.get("ln1_b"))
    x = x + _attn_forward(
        cfg, p, h, positions=positions, window=window,
        cache=None if cache is None else cache["attn"],
        cache_index=cache_index, use_pallas=use_pallas)
    if cfg.d_ff:
        h = _norm(cfg, x, p["ln2"], p.get("ln2_b"))
        x = x + _mlp_forward(cfg, p, h)
    return x


# ---------------------------------------------------------------------------
# the layer loop
# ---------------------------------------------------------------------------


def _layer_of(tree, i):
    return {k: (_layer_of(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _run_decoder_stack(cfg: ArchConfig, params, x, *, positions, caches=None,
                       cache_index=None, use_pallas=None):
    """The dense stack: one block a layer over the stacked params (and the
    stacked caches, written in place)."""
    stacked = params["blocks"]
    b_caches = None if caches is None else caches["blocks"]
    for i in range(cfg.num_layers):
        x = block_forward(
            cfg, _layer_of(stacked, i), x, positions=positions,
            window=cfg.sliding_window,
            cache=None if b_caches is None else _layer_of(b_caches, i),
            cache_index=cache_index, use_pallas=use_pallas)
    return x


def _embed_inputs(cfg: ArchConfig, params, batch):
    """Token embedding. Returns (x, positions)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    return x, positions


def _logits(cfg: ArchConfig, params, x):
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["unembed"]


def _softmax_xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-token CE, the forward of the reference's custom-VJP CE: fp32
    log-sum-exp with the max taken out, minus the target's logit."""
    l32 = logits.float()
    mx = l32.amax(dim=-1, keepdim=True)
    lse = torch.log(torch.exp(l32 - mx).sum(dim=-1)) + mx[..., 0]
    picked = l32.gather(-1, targets[..., None].long())[..., 0]
    return lse - picked


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def loss_fn(cfg: ArchConfig, params, batch):
    """Next-token CE (forward value only: the port does not train LMs).
    batch: tokens [B, S]."""
    _require_dense(cfg, "loss_fn")
    x, positions = _embed_inputs(cfg, params, batch)
    x = _run_decoder_stack(cfg, params, x, positions=positions)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))
    tokens = batch["tokens"]
    logits = _logits(cfg, params, x[:, :-1])
    return _softmax_xent(logits, tokens[:, 1:]).mean()


def init_cache(cfg: ArchConfig, batch_size: int, max_len: int, *,
               device):
    """Stacked attention caches sized for `max_len` (ring-buffered for
    SWA), zeros of the config's dtype on `device`."""
    _require_dense(cfg, "init_cache")
    dt = _dtype(cfg)
    clen = (min(cfg.sliding_window, max_len) if cfg.sliding_window
            else max_len)
    shape = (cfg.num_layers, batch_size, cfg.num_kv_heads, clen,
             cfg.resolved_head_dim)
    return {"blocks": {"attn": {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device)}}}


def prefill(cfg: ArchConfig, params, batch, max_len: Optional[int] = None,
            *, use_pallas=None):
    """Forward over a prompt, producing (last-token logits, filled caches).
    `use_pallas` reaches every attention call (None: the kernels on the
    card)."""
    _require_dense(cfg, "prefill")
    x, positions = _embed_inputs(cfg, params, batch)
    b, s = x.shape[0], x.shape[1]
    caches = init_cache(cfg, b, max_len or s, device=x.device)
    cache_index = torch.zeros((), dtype=torch.int32, device=x.device)
    x = _run_decoder_stack(
        cfg, params, x, positions=positions, caches=caches,
        cache_index=cache_index, use_pallas=use_pallas)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))
    logits = _logits(cfg, params, x[:, -1:])
    return logits[:, 0], caches


def decode_step(cfg: ArchConfig, params, tokens, caches, cache_index, *,
                use_pallas=None):
    """One greedy-decode step. tokens [B, 1]; cache_index: 0-d int32 tensor
    on the params' device (or an int) — number of tokens already in the
    cache. Returns (logits [B, V], caches), the caches written in place.
    Nothing here reads a device value back to the host."""
    _require_dense(cfg, "decode_step")
    b = tokens.shape[0]
    device = params["embed"].device
    cache_index = torch.as_tensor(cache_index, dtype=torch.int32,
                                  device=device)
    positions = cache_index.reshape(1, 1).expand(b, 1)
    x, positions = _embed_inputs(cfg, params, {"tokens": tokens,
                                               "positions": positions})
    x = _run_decoder_stack(
        cfg, params, x, positions=positions, caches=caches,
        cache_index=cache_index, use_pallas=use_pallas)
    x = _norm(cfg, x, params["final_norm"], params.get("final_norm_b"))
    return _logits(cfg, params, x)[:, 0], caches

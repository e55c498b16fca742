"""LM serving: batched prefill + greedy decode with a KV cache; twin of
repro/launch/serve.py, for all ten architectures.

On the card every prefill layer's attention launches the flash kernel and
every decode layer's the decode kernel (models/layers.py routes them;
mamba2 has no attention).
Runs on the card unless `--device cpu` is given; with `--device cuda` and
no GPU visible it raises.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --batch 4 --prompt-len 64 --gen 32
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config, smoke_config
from repro_torch.core.device import DEVICES, resolve_device
from repro_torch.models import lm


def _now(device: torch.device) -> float:
    """The host clock after the card has finished what it was given."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _bf16(a: np.ndarray, device) -> torch.Tensor:
    """A float64 NumPy array rounded to bfloat16 on the host (as the
    reference's `jnp.asarray(a, jnp.bfloat16)` rounds it), then placed on
    `device`."""
    return torch.from_numpy(a).to(torch.bfloat16).to(device)


def serve_inputs(cfg, rng: np.random.Generator, batch: int, prompt_len: int,
                 device) -> tuple[dict, int]:
    """The prompt batch, drawn from `rng` in the reference's order: the
    tokens, then whisper's frame embeddings, then the VLM's
    min(num_patches, 8) patch embeddings, with the M-RoPE positions over
    patches and tokens. Returns (batch, the prompt's length with the patch
    prefix)."""
    batch_in = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (batch, prompt_len)),
        dtype=torch.int32, device=device)}
    if cfg.encoder_decoder:
        batch_in["frames"] = _bf16(
            rng.normal(size=(batch, cfg.encoder_seq, cfg.d_model)), device)
    if cfg.family == "vlm":
        p = min(cfg.num_patches, 8)
        batch_in["patch_embeds"] = _bf16(
            rng.normal(size=(batch, p, cfg.d_model)), device)
        prompt_len = p + prompt_len
        batch_in["pos3"] = torch.arange(
            prompt_len, dtype=torch.int32, device=device)[None, None].expand(
                3, batch, prompt_len)
    return batch_in, prompt_len


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 64, gen: int = 32, seed: int = 0,
          device="cuda"):
    """Prefill `batch` random prompts of `prompt_len` tokens, then decode
    greedily to `gen` tokens a sequence. Returns (sequences [batch, gen],
    prefill seconds, decode seconds). Weights are drawn from a generator
    on `device` seeded with `seed`, the prompts from NumPy's. The prefill
    seconds include building the kernels in a fresh process, as the
    reference's include its jit compile; the decode loop never reads a
    device value back to the host. As the reference does, the caches hold
    `prompt_len + gen` slots, the VLM's patch prefix not counted: its last
    decode steps write the clamped last slot."""
    if isinstance(device, str):
        device = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    lm.set_activation_sharding(None)
    with torch.inference_mode():
        params = lm.init_params(
            cfg, torch.Generator(device=device).manual_seed(seed), device)
        rng = np.random.default_rng(seed)
        max_len = prompt_len + gen
        batch_in, prompt_len = serve_inputs(cfg, rng, batch, prompt_len,
                                            device)

        t0 = _now(device)
        logits, caches = lm.prefill(cfg, params, batch_in, max_len=max_len)
        t_prefill = _now(device) - t0

        tokens = torch.argmax(logits, -1)[:, None].to(torch.int32)
        out_tokens = [tokens]
        idx = torch.full((), prompt_len, dtype=torch.int32, device=device)
        t0 = _now(device)
        for _ in range(gen - 1):
            pos3 = (idx.reshape(1, 1, 1).expand(3, batch, 1)
                    if cfg.family == "vlm" else None)
            logits, caches = lm.decode_step(cfg, params, tokens, caches, idx,
                                            pos3=pos3)
            tokens = torch.argmax(logits, -1)[:, None].to(torch.int32)
            out_tokens.append(tokens)
            idx = idx + 1
        t_decode = _now(device) - t0
        seqs = torch.cat(out_tokens, dim=1)
    return seqs, t_prefill, t_decode


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=list(DEVICES),
                    help="run on the card (default) or the CPU")
    args = ap.parse_args(argv)
    seqs, t_prefill, t_decode = serve(
        args.arch, batch=args.batch, prompt_len=args.prompt_len,
        gen=args.gen, device=args.device)
    per_tok = t_decode / max(args.gen - 1, 1) / args.batch * 1e3
    print(f"[serve] generated {tuple(seqs.shape)} tokens; prefill "
          f"{t_prefill:.2f}s, decode {t_decode:.2f}s ({per_tok:.1f} "
          "ms/token/seq)")
    print("[serve] sample:", seqs[0, :16].cpu().tolist())


if __name__ == "__main__":
    main()

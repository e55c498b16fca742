"""qwen2-vl-2b [arXiv:2409.12191]: VLM backbone — M-RoPE (3 position
streams), GQA kv=2. Vision frontend is a STUB: input_specs provides
precomputed patch embeddings occupying the first `num_patches` sequence
positions (dynamic resolution folded into the stub)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    mrope=True,
    mrope_sections=(16, 24, 24),  # head_dim 128 -> half 64 = 16+24+24
    num_patches=1024,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen2-vl-2b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
    mrope=True,
    mrope_sections=(4, 2, 2),  # head_dim 16 -> half 8
    num_patches=8,
)

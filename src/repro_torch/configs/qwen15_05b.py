"""qwen1.5-0.5b [hf:Qwen/Qwen1.5-0.5B]: dense, MHA (kv=16), QKV bias,
tied embeddings."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1e6,
)

SMOKE = ArchConfig(
    name="qwen1.5-0.5b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=160,
    vocab_size=256,
    qkv_bias=True,
    tie_embeddings=True,
)

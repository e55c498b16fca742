"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct]: 16 experts,
top-2 routing, GQA kv=8."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    moe=True,
    num_experts=16,
    experts_per_token=2,
    rope_theta=1e4,
)

SMOKE = ArchConfig(
    name="phi3.5-moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    moe=True,
    num_experts=4,
    experts_per_token=2,
)

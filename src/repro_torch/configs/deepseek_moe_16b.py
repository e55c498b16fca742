"""deepseek-moe-16b [arXiv:2401.06066]: fine-grained MoE — 64 routed experts
(top-6, d_ff 1408) + 2 shared experts; layer 0 is a dense MLP (d_ff 10944);
MHA kv=16."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=True,
    num_experts=64,
    experts_per_token=6,
    num_shared_experts=2,
    first_layer_dense=True,
    dense_d_ff=10944,
    rope_theta=1e4,
)

SMOKE = ArchConfig(
    name="deepseek-moe-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=48,
    vocab_size=256,
    moe=True,
    num_experts=8,
    experts_per_token=2,
    num_shared_experts=1,
    first_layer_dense=True,
    dense_d_ff=160,
)

"""hymba-1.5b [arXiv:2411.13676]: hybrid — parallel attention + mamba heads
in every block; SWA everywhere except 3 global-attention layers
(first / middle / last). Meta-tokens are omitted (stub; DESIGN.md §6).
"""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=2048,
    num_global_layers=3,
    hybrid=True,
    ssm=True,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
)

SMOKE = ArchConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    num_layers=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=256,
    sliding_window=16,
    num_global_layers=2,
    hybrid=True,
    ssm=True,
    ssm_state=8,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_groups=1,
)

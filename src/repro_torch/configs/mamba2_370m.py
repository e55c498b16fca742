"""mamba2-370m [arXiv:2405.21060]: attention-free SSM with SSD
(state-space duality), chunked scan. d_inner = 2*d_model = 2048,
64-dim SSM heads, state N=128."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_groups=1,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="mamba2-370m-smoke",
    family="ssm",
    num_layers=3,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    ssm=True,
    ssm_state=16,
    ssm_head_dim=16,
    ssm_expand=2,
    ssm_groups=1,
    tie_embeddings=True,
)

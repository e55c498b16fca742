"""h2o-danube-1.8b [arXiv:2401.16818]: llama+mistral mix, GQA kv=8,
sliding-window attention (window 4096)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e4,
)

SMOKE = ArchConfig(
    name="h2o-danube-1.8b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=160,
    vocab_size=256,
    sliding_window=32,
)

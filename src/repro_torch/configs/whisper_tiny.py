"""whisper-tiny [arXiv:2212.04356]: encoder-decoder audio model. The conv
mel-frontend is a STUB — input_specs provides precomputed frame embeddings
[B, 1500, d]. LayerNorm + GELU MLP (no RoPE; learned positions)."""

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm="layernorm",
    mlp="gelu",
    encoder_decoder=True,
    encoder_layers=4,
    # real whisper emits 1500 frames; the stub frontend pads to 1536 so the
    # encoder/cross attention tiles on 128-wide blocks (MXU alignment) and
    # takes the flash path instead of materialising f32 score matrices
    encoder_seq=1536,
)

SMOKE = ArchConfig(
    name="whisper-tiny-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=160,
    vocab_size=256,
    norm="layernorm",
    mlp="gelu",
    encoder_decoder=True,
    encoder_layers=2,
    encoder_seq=64,
)

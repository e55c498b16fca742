"""Architecture + shape configs for the assigned evaluation pool.

A verbatim copy of repro/configs/base.py (the imports redirected to this
package): the port keeps its own copy, and tests/test_torch_lm.py holds
every config field for field to the reference's.

Each assigned architecture gets one module in this package defining
``CONFIG`` (exact values from the assignment table) and ``SMOKE``
(a reduced same-family config for CPU smoke tests). ``get_config(arch)``
resolves either.

Shapes (same four for every LM arch):
  train_4k     seq 4096  x global_batch 256   -> train_step
  prefill_32k  seq 32768 x global_batch 32    -> prefill_step
  decode_32k   cache 32768 x global_batch 128 -> decode_step
  long_500k    cache 524288 x global_batch 1  -> decode_step (sub-quadratic
               archs only: mamba2 / hymba; skips noted in DESIGN.md §6)
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

ARCH_IDS = (
    "qwen1.5-0.5b",
    "qwen3-4b",
    "h2o-danube-1.8b",
    "yi-6b",
    "hymba-1.5b",
    "qwen2-vl-2b",
    "phi3.5-moe-42b-a6.6b",
    "deepseek-moe-16b",
    "whisper-tiny",
    "mamba2-370m",
)

_MODULES = {
    "qwen1.5-0.5b": "qwen15_05b",
    "qwen3-4b": "qwen3_4b",
    "h2o-danube-1.8b": "h2o_danube_18b",
    "yi-6b": "yi_6b",
    "hymba-1.5b": "hymba_15b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-370m": "mamba2_370m",
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                 # 0 for attention-free
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0        # 0 = full attention
    num_global_layers: int = 0     # hymba: layers with full attention
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp: str = "swiglu"            # swiglu | gelu
    tie_embeddings: bool = False
    # MoE
    moe: bool = False
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0
    first_layer_dense: bool = False
    dense_d_ff: int = 0            # deepseek layer-0 dense MLP width
    moe_capacity_factor: float = 1.25  # expert buffer slack (1.0 = exact top-k)
    # SSM (mamba2 / hybrid)
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4
    hybrid: bool = False           # parallel attn + ssm heads per layer
    # encoder-decoder (whisper)
    encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500        # stub conv frontend output frames
    # VLM
    mrope: bool = False
    mrope_sections: tuple = (16, 24, 24)
    num_patches: int = 1024        # stub vision frontend patches in sequence
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: O(1)-per-token decode state (SSM) or a
        bounded attention window (SWA). Pure full-attention archs skip the
        long_500k cell (DESIGN.md §6)."""
        return self.ssm or self.sliding_window > 0

    def param_count(self) -> int:
        """Analytic parameter count (drives 6ND roofline math)."""
        d, L = self.d_model, self.num_layers
        hd = self.resolved_head_dim
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.num_heads:
            per_layer += d * self.num_heads * hd + d * self.num_kv_heads * hd * 2
            per_layer += self.num_heads * hd * d
        if self.ssm:
            din = self.ssm_inner
            g, n, h = self.ssm_groups, self.ssm_state, self.ssm_heads
            per_layer += d * (2 * din + 2 * g * n + h) + din * d
        if self.moe:
            per_layer += d * self.num_experts
            per_layer += self.num_experts * 3 * d * self.d_ff
            per_layer += self.num_shared_experts * 3 * d * self.d_ff
        elif self.mlp == "swiglu":
            per_layer += 3 * d * self.d_ff
        else:
            per_layer += 2 * d * self.d_ff
        total += per_layer * L
        if self.first_layer_dense and self.dense_d_ff:
            total += 3 * d * self.dense_d_ff - (
                d * self.num_experts
                + (self.num_experts + self.num_shared_experts) * 3 * d * self.d_ff
            )
        if self.encoder_decoder:
            enc = self.encoder_layers * (
                4 * d * d + 2 * d * self.d_ff
            )
            total += enc + self.num_layers * 4 * d * d  # cross-attention
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared experts only)."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        inactive = (
            (self.num_experts - self.experts_per_token) * 3 * d * self.d_ff * L
        )
        return int(self.param_count() - inactive)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ArchConfig:
    if arch not in _MODULES:
        raise ValueError(f"unknown arch {arch!r}; options: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def smoke_config(arch: str) -> ArchConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.SMOKE


def list_archs() -> tuple[str, ...]:
    return ARCH_IDS


def shape_cells(arch: str) -> list[str]:
    """The dry-run cells for this arch (long_500k only if sub-quadratic)."""
    cfg = get_config(arch)
    cells = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        cells.append("long_500k")
    return cells

"""The device an entry point runs on: the card unless the caller asks for
the CPU, and never a silent fallback."""

from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """`torch.device(name)`; raises if `name` is "cuda" and no GPU is
    visible, and fixes fp32 numerics (TF32 off for matmuls and cuDNN)."""
    if name not in DEVICES:
        raise ValueError(f"unknown device {name!r}; options: {DEVICES}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: no CUDA device is visible (torch.cuda."
            "is_available() is False); pass --device cpu to run on the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device(name)

"""Flash attention forward: the hand-written CUDA kernel, its wrapper, and
its plain PyTorch version.

The kernel (csrc/flash_attention.cu) replaces the TPU kernel
repro/kernels/flash_attention.py:flash_attention. Both dtypes walk 128-row q
tiles. bf16 runs on Hopper's `wgmma`, fed by TMA copies of 128-key K/V
tiles into a two-stage ring (the tensor maps are encoded per call on the
host). fp32 runs on fp32 FMAs, with 64-key tiles double-buffered by
`cp.async`. It is built at first use (kernels/_build.py) and bound with
ctypes; a failed build or launch raises (there is no fallback).

`flash_attention` launches the kernel on CUDA tensors only;
`flash_attention_plain` computes the same function in plain PyTorch on any
device (kernels/ops.py dispatches). Both take folded [BH, S, D] tensors.
A causal call needs Sq == Skv: the TPU kernel masks q_idx >= k_idx from the
top left, its oracle from the bottom right, and the two agree only on
square inputs. `LAUNCHES` counts the kernel's launches per
(BH, Sq, Skv, D, dtype, causal).
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaLibrary

HEAD_DIMS = (64, 128)
# kernel launches per (BH, Sq, Skv, D, dtype, causal); chip_smoke.py zeroes
# and reads them
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention.cu", "flash_attention", _bind)


def launch_inputs(what: str, dtypes, *tensors):
    """The checks before a launch on tensors of one float dtype: all on one
    CUDA device, of one dtype in `dtypes`, no gradient requested. Returns
    them contiguous and 16-byte aligned (the kernels load 16-byte vectors)."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"the {what} kernel takes CUDA tensors; use the "
                         "plain version for CPU tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors]}")
    if tensors[0].dtype not in dtypes or len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"{what}: dtypes {[t.dtype for t in tensors]}; the "
                        f"kernel takes one of {list(dtypes)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"the {what} kernel is forward only")
    out = []
    for t in tensors:
        t = t.contiguous()
        out.append(t if t.data_ptr() % 16 == 0 else t.clone())
    return out


def _check_shapes(q, k, v, causal: bool) -> None:
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; want [BH, S, D]")
    if q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in BH or D")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal attention needs Sq == Skv, got {q.shape[1]} and "
            f"{k.shape[1]}: the kernel's top-left mask and the oracle's "
            "bottom-right mask disagree otherwise")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel: q [BH, Sq, D], k, v [BH, Skv, D] of one dtype
    (float32 or bfloat16), D in HEAD_DIMS; returns [BH, Sq, D] in q's
    dtype. Forward only: raises if a gradient is requested."""
    _check_shapes(q, k, v, causal)
    bh, sq, d = q.shape
    skv = k.shape[1]
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if min(bh, sq, skv) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    q, k, v = launch_inputs("flash attention", _DTYPES, q, k, v)
    out = torch.empty_like(q)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            skv, d, _DTYPES[q.dtype], int(causal), 1.0 / math.sqrt(d), stream)
    LIBRARY.check(rc, "flash_attention")
    LAUNCHES[(bh, sq, skv, d, str(q.dtype).removeprefix("torch."),
              causal)] += 1
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the oracle on
    the folded tensors."""
    _check_shapes(q, k, v, causal)
    return ref.flash_attention_ref(q[None], k[None], v[None],
                                   causal=causal)[0]

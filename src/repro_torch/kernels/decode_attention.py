"""Single-token decode attention: the hand-written CUDA kernel, its wrapper,
and its plain PyTorch version.

The kernel (csrc/decode_attention.cu) replaces the TPU kernel
repro/kernels/decode_attention.py:decode_attention. It is built at first use
(kernels/_build.py) and bound with ctypes; a failed build or launch raises.

`decode_attention` launches the kernel on CUDA tensors only;
`decode_attention_plain` computes the same function in plain PyTorch on any
device (kernels/ops.py dispatches). Both take folded tensors: q [BH, D],
k, v [BH, S, D], and `valid_len`, an int or a 0-d integer tensor. The kernel
reads `valid_len` from a device int32, so a call never waits for the host.
`LAUNCHES` counts the kernel's launches per (BH, S, D, dtype).
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.flash_attention import launch_inputs

HEAD_DIMS = (64, 128)
# kernel launches per (BH, S, D, dtype); chip_smoke.py zeroes and reads them
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.decode_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.decode_attention.restype = ctypes.c_int


LIBRARY = CudaLibrary("decode_attention.cu", "decode_attention", _bind)


def _check_shapes(q, k, v, valid_len) -> None:
    if q.dim() != 2 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; want q [BH, D], k, v "
                         "[BH, S, D]")
    if q.shape != (k.shape[0], k.shape[2]):
        raise ValueError(f"q {tuple(q.shape)} does not match the cache "
                         f"{tuple(k.shape)}")
    if isinstance(valid_len, torch.Tensor) and (
            valid_len.dim() != 0 or valid_len.is_floating_point()
            or valid_len.is_complex()):
        raise TypeError("valid_len must be an int or a 0-d integer tensor, "
                        f"got {valid_len.dtype} of shape "
                        f"{tuple(valid_len.shape)}")


def _valid_on(valid_len, device: torch.device) -> torch.Tensor:
    """valid_len as one int32 on `device`, without a host sync: an int is
    filled on the device; a tensor is cast (and copied if it is elsewhere)."""
    if isinstance(valid_len, torch.Tensor):
        return valid_len.to(device=device, dtype=torch.int32).reshape(1)
    # int32 range: anything past S means "all valid", anything below 1 "none"
    clamped = max(min(int(valid_len), 2**31 - 1), -2**31)
    return torch.full((1,), clamped, dtype=torch.int32, device=device)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len) -> torch.Tensor:
    """Launch the CUDA kernel: q [BH, D], k, v [BH, S, D] of one dtype
    (float32 or bfloat16), D in HEAD_DIMS; returns [BH, D] in q's dtype.
    Forward only: raises if a gradient is requested."""
    _check_shapes(q, k, v, valid_len)
    bh, s, d = k.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if min(bh, s) == 0:
        raise ValueError(f"empty cache {tuple(k.shape)}")
    q, k, v = launch_inputs("decode attention", _DTYPES, q, k, v)
    valid = _valid_on(valid_len, q.device)
    out = torch.empty_like(q)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), bh, s, d, _DTYPES[q.dtype], 1.0 / math.sqrt(d),
            stream)
    LIBRARY.check(rc, "decode_attention")
    LAUNCHES[(bh, s, d, str(q.dtype).removeprefix("torch."))] += 1
    return out


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the oracle on
    the folded tensors."""
    _check_shapes(q, k, v, valid_len)
    return ref.decode_attention_ref(q[None], k[None], v[None], valid_len)[0]

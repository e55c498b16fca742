"""Flash attention: the hand-written CUDA forward and backward kernels,
their wrappers, and their plain PyTorch versions.

The kernel (csrc/flash_attention.cu) replaces the TPU kernel
repro/kernels/flash_attention.py:flash_attention. Both dtypes walk 128-row q
tiles. bf16 runs on Hopper's `wgmma`, fed by TMA copies of 128-key K/V
tiles into a two-stage ring (the tensor maps are encoded per call on the
host). fp32 runs on fp32 FMAs, with 64-key tiles double-buffered by
`cp.async`. It is built at first use (kernels/_build.py) and bound with
ctypes; a failed build or launch raises (there is no fallback). With
`return_lse=True` the forward also writes each row's fp32 log-sum-exp.

The backward (csrc/flash_attention_bwd.cu, its own library) replaces no
TPU kernel: it is the twin of the reference's blockwise jnp backward
(repro/models/layers.py:_flash_bwd), from the forward's out and lse:
delta = rowsum(dout * out), then dK / dV in one kernel (a block per key
tile) and dQ in another (a block per q tile), no atomics. bf16 runs on
`wgmma` fed by TMA like the forward: dK / dV a block per 128-key tile
with 64-row q / dout tiles streamed through a two-stage ring, dQ a block
per 128-row q tile with 64-key K / V tiles; P and dS are rounded to bf16
as the products' operands. fp32 runs on fp32 FMAs, 64-row and 64-key
tiles.

`flash_attention` / `flash_attention_bwd` launch the kernels on CUDA
tensors only; `flash_attention_plain` / `flash_attention_bwd_plain`
compute the same functions in plain PyTorch on any device (kernels/ops.py
dispatches, and its autograd Function pairs them). All take folded
[BH, S, D] tensors. A causal call needs Sq == Skv: the TPU kernel masks
q_idx >= k_idx from the top left, its oracle from the bottom right, and
the two agree only on square inputs. `LAUNCHES` / `BWD_LAUNCHES` count
the wrappers' launches per (BH, Sq, Skv, D, dtype, causal); a backward
launch runs its three kernels.
"""

from __future__ import annotations

import ctypes
import math
from collections import Counter

import numpy as np
import torch

from repro_torch.kernels._build import CudaLibrary

HEAD_DIMS = (64, 128)
# kernel launches per (BH, Sq, Skv, D, dtype, causal); chip_smoke.py zeroes
# and reads them
LAUNCHES: Counter = Counter()
BWD_LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.flash_attention.argtypes = [
        *[ctypes.c_void_p] * 5, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention.restype = ctypes.c_int


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.flash_attention_bwd.argtypes = [
        *[ctypes.c_void_p] * 10, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    lib.flash_attention_bwd.restype = ctypes.c_int


LIBRARY = CudaLibrary("flash_attention.cu", "flash_attention", _bind)
BWD_LIBRARY = CudaLibrary("flash_attention_bwd.cu", "flash_attention_bwd",
                          _bind_bwd)


def launch_inputs(what: str, dtypes, *tensors):
    """The checks before a launch on tensors of one float dtype: all on one
    CUDA device, of one dtype in `dtypes`, no gradient requested (a
    kernel called directly records no backward: ops.flash_attention's
    autograd Function pairs the forward kernel with the backward one).
    Returns them contiguous and 16-byte aligned (the kernels load 16-byte
    vectors)."""
    if not all(t.is_cuda for t in tensors):
        raise ValueError(f"the {what} kernel takes CUDA tensors; use the "
                         "plain version for CPU tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors]}")
    if tensors[0].dtype not in dtypes or len({t.dtype for t in tensors}) != 1:
        raise TypeError(f"{what}: dtypes {[t.dtype for t in tensors]}; the "
                        f"kernel takes one of {list(dtypes)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"the {what} kernel is forward only when called directly "
            "(ops.flash_attention differentiates flash attention through "
            "its autograd Function)")
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


def _check_kernel_shapes(q, k) -> None:
    bh, sq, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if min(bh, sq, k.shape[1]) == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def _key(q, k, causal: bool) -> tuple:
    bh, sq, d = q.shape
    return (bh, sq, k.shape[1], d, str(q.dtype).removeprefix("torch."),
            causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, return_lse: bool = False):
    """Launch the CUDA kernel: q [BH, Sq, D], k, v [BH, Skv, D] of one dtype
    (float32 or bfloat16), D in HEAD_DIMS; returns [BH, Sq, D] in q's
    dtype, and with `return_lse` also each row's log-sum-exp [BH, Sq]
    (float32). Raises if a gradient is requested (see `launch_inputs`)."""
    _check_shapes(q, k, v, causal)
    _check_kernel_shapes(q, k)
    bh, sq, d = q.shape
    q, k, v = launch_inputs("flash attention", _DTYPES, q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty(bh, sq, dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, sq, k.shape[1], d,
            _DTYPES[q.dtype], int(causal), 1.0 / math.sqrt(d), stream)
    LIBRARY.check(rc, "flash_attention")
    LAUNCHES[_key(q, k, causal)] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True) -> tuple:
    """Launch the CUDA backward: q, out, dout [BH, Sq, D], k, v [BH, Skv,
    D] of one dtype, lse [BH, Sq] float32 (the forward's); returns (dq,
    dk, dv) in that dtype."""
    _check_shapes(q, k, v, causal)
    _check_kernel_shapes(q, k)
    bh, sq, d = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must match q {tuple(q.shape)}")
    if lse.shape != (bh, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse {tuple(lse.shape)} {lse.dtype}: want "
                         f"float32 [{bh}, {sq}]")
    q, k, v, out, dout = launch_inputs("flash attention backward", _DTYPES,
                                       q, k, v, out, dout)
    (lse,) = launch_inputs("flash attention backward", (torch.float32,), lse)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty(bh, sq, dtype=torch.float32, device=q.device)
    lib = BWD_LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_bwd(
            *(t.data_ptr() for t in (q, k, v, out, dout, lse, delta, dq, dk,
                                     dv)),
            bh, sq, k.shape[1], d, _DTYPES[q.dtype], int(causal),
            1.0 / math.sqrt(d), stream)
    BWD_LIBRARY.check(rc, "flash_attention_bwd")
    BWD_LAUNCHES[_key(q, k, causal)] += 1
    return dq, dk, dv


def _scores(q, k) -> torch.Tensor:
    """The oracle's fp32 scores [BH, Sq, Skv]: a q-dtype product cast to
    fp32 and scaled by 1/sqrt(D)."""
    return torch.einsum("bqd,bkd->bqk", q, k).float() * (
        1.0 / np.sqrt(q.shape[-1]))


def _causal_keep(q, k) -> torch.Tensor:
    """[Sq, Skv] bool: the (query, key) pairs a causal call keeps, k_idx <=
    q_idx + (Skv - Sq) (the oracle's bottom-right mask)."""
    sq, sk = q.shape[1], k.shape[1]
    return (torch.arange(sq, device=q.device)[:, None] + (sk - sq)
            >= torch.arange(sk, device=q.device)[None, :])


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, return_lse: bool = False):
    """The kernel's function in plain PyTorch, on any device: the oracle
    (`ref.flash_attention_ref`) on the folded tensors, scores masked to
    -1e30, softmax in fp32, p cast to q's dtype before PV. With
    `return_lse` also the rows' fp32 log-sum-exp m + log(max(l, 1e-30))
    (the reference's `lse_blk`)."""
    _check_shapes(q, k, v, causal)
    scores = _scores(q, k)
    if causal:
        scores = torch.where(_causal_keep(q, k), scores, -1e30)
    out = torch.einsum("bqk,bkd->bqd",
                       torch.softmax(scores, dim=-1).to(q.dtype), v)
    if not return_lse:
        return out
    m = scores.amax(dim=-1)
    l_sum = torch.exp(scores - m[..., None]).sum(dim=-1)
    return out, m + torch.log(torch.clamp(l_sum, min=1e-30))


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True) -> tuple:
    """The backward kernel's function in plain PyTorch, on any device: the
    reference's `_flash_bwd` op for op over one block (P in fp32 from the
    forward's lse, zero where masked; products of q-dtype operands cast to
    fp32 where the reference casts them). Returns (dq, dk, dv) in the
    inputs' dtypes."""
    _check_shapes(q, k, v, causal)
    scale = 1.0 / float(np.sqrt(q.shape[-1]))
    delta = (out.float() * dout.float()).sum(dim=-1)
    p = torch.exp(_scores(q, k) - lse[..., None])
    if causal:
        p = torch.where(_causal_keep(q, k), p, 0.0)
    dv = torch.einsum("bqk,bqd->bkd", p, dout.float())
    dp = torch.einsum("bqd,bkd->bqk", dout, v).float()
    ds = p * (dp - delta[..., None]) * scale
    dk = torch.einsum("bqk,bqd->bkd", ds, q.float())
    dq = torch.einsum("bqk,bkd->bqd", ds, k.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

"""Tiled segment reduce (sum | max): the hand-written CUDA kernel, its
wrapper, and its plain PyTorch version.

The kernel (csrc/segment_reduce.cu) replaces the TPU kernel
repro/kernels/segment_spmm.py:segment_spmm. It is compiled with nvcc for
sm_90a into a shared library with a plain C interface at first use, under
`build/repro_torch/` at the repository root (kernels/_build.py), and bound
with ctypes. A failed build or launch raises.

`segment_spmm` launches the kernel on CUDA tensors only; `segment_spmm_plain`
computes the same function with index_add_ / scatter_reduce_ and is what a
CPU tensor gets (kernels/ops.py dispatches). `LAUNCHES` counts the kernel's
launches per (combiner, num_rows, F): one count per shape it ran at.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.tiling import DEFAULT_BLOCK_E, DEFAULT_TILE_V

COMBINERS = ("sum", "max")

# kernel launches per (combiner, num_rows, F); chip_smoke.py zeroes and
# reads them
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    lib.segment_reduce.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.segment_reduce.restype = ctypes.c_int


LIBRARY = CudaLibrary("segment_reduce.cu", "segment_reduce", _bind)
SOURCE = LIBRARY.source


def _check_layout(e: int, num_rows: int, tile_v: int, block_e: int) -> int:
    """Tile count of a layout over `num_rows` (a multiple of tile_v) rows
    whose tiles hold a whole number of `block_e` edge blocks."""
    if num_rows % tile_v or num_rows <= 0:
        raise ValueError(f"num_rows {num_rows} is not a positive multiple "
                         f"of tile_v {tile_v}")
    n_tiles = num_rows // tile_v
    if e % (n_tiles * block_e):
        raise ValueError(f"{e} edges do not split into {n_tiles} row tiles "
                         f"of whole {block_e}-edge blocks")
    return n_tiles


def segment_spmm(
    messages: torch.Tensor,   # [E, F] f32 | bf16, blocked by row tile
    local_dst: torch.Tensor,  # [E] int32 row id within the edge's tile
    num_rows: int,            # rows_padded: a multiple of tile_v
    *,
    combiner: str = "sum",
    tile_v: int = DEFAULT_TILE_V,
    block_e: int = DEFAULT_BLOCK_E,
) -> torch.Tensor:
    """Launch the CUDA kernel: [num_rows, F] in the messages' dtype. Rows no
    edge reaches come back as the combiner identity (0 / -inf). Forward
    only: raises if a gradient is requested."""
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}; options: {COMBINERS}")
    if messages.requires_grad and torch.is_grad_enabled():
        raise RuntimeError("the segment reduce kernel is forward only")
    if not (messages.is_cuda and local_dst.is_cuda):
        raise ValueError("the segment reduce kernel takes CUDA tensors; "
                         "use segment_spmm_plain for CPU tensors")
    if messages.device != local_dst.device:
        raise ValueError(f"messages on {messages.device}, local_dst on "
                         f"{local_dst.device}")
    if messages.dtype not in _DTYPES:
        raise TypeError(f"messages dtype {messages.dtype}: the kernel takes "
                        f"{list(_DTYPES)}")
    if local_dst.dtype != torch.int32:
        raise TypeError(f"local_dst must be int32, got {local_dst.dtype}")
    if messages.dim() != 2 or local_dst.shape != messages.shape[:1]:
        raise ValueError(f"shapes: messages {tuple(messages.shape)}, "
                         f"local_dst {tuple(local_dst.shape)}")
    messages = messages.contiguous()
    local_dst = local_dst.contiguous()
    e, f = messages.shape
    n_tiles = _check_layout(e, num_rows, tile_v, block_e)
    out = messages.new_empty((num_rows, f))
    if f == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(messages.device):
        stream = torch.cuda.current_stream(messages.device).cuda_stream
        rc = lib.segment_reduce(
            messages.data_ptr(), local_dst.data_ptr(), out.data_ptr(),
            n_tiles, e // n_tiles, tile_v, f, _DTYPES[messages.dtype],
            COMBINERS.index(combiner), stream)
    LIBRARY.check(rc, "segment_reduce")
    LAUNCHES[(combiner, num_rows, f)] += 1
    return out


def segment_spmm_plain(
    messages: torch.Tensor,
    local_dst: torch.Tensor,
    num_rows: int,            # rows_padded: a multiple of tile_v
    *,
    combiner: str = "sum",
    tile_v: int = DEFAULT_TILE_V,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: rebuild global
    row ids from the tile-relative `local_dst` (pad edges -> the sink row
    num_rows) and segment-reduce with the ref.py versions."""
    if combiner not in COMBINERS:
        raise ValueError(f"unknown combiner {combiner!r}; options: {COMBINERS}")
    e = messages.shape[0]
    n_tiles = _check_layout(e, num_rows, tile_v, 1)
    per_tile = e // n_tiles
    tile_idx = torch.arange(e, device=messages.device) // per_tile
    ldst = local_dst.long()
    gdst = torch.where(ldst >= tile_v, num_rows, tile_idx * tile_v + ldst)
    if combiner == "max":
        return ref.segment_max_ref(messages, gdst, num_rows)
    return ref.segment_sum_ref(messages, gdst, num_rows)

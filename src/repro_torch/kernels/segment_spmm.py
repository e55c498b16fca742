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
`_launch_plan` sizes each launch (column slices, owner units, warps, shared
memory, grid) here in Python, where the CPU tests can check it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from dataclasses import dataclass

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.tiling import DEFAULT_BLOCK_E, DEFAULT_TILE_V

COMBINERS = ("sum", "max")

# kernel launches per (combiner, num_rows, F); chip_smoke.py zeroes and
# reads them
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SMEM_LIMIT = 232_448   # dynamic shared memory a block may use on an H100
MAX_THREADS = 512      # the kernel's __launch_bounds__ (kMaxThreads)
MAX_STAGE = 2048       # local_dst slots a shared-memory stage holds
SEG_SLOTS = 4096       # about this many slots a segment of a split tile
MAX_SPLITS = 16
PARTIAL_BYTES = 512 << 20  # fp32 partials of a split launch, at most
GRID_LIMIT = 2**31 - 1


@dataclass(frozen=True)
class LaunchPlan:
    """One launch of csrc/segment_reduce.cu. A tile's slots are split into
    `n_splits` segments of `seg` slots; block b takes column group
    b % n_col_groups (`cols` columns) of segment b // n_col_groups (tile
    b // (n_col_groups * n_splits)). Its warps split into owner units of
    `lanes` lanes; unit u = warp * (32 // lanes) + lane // lanes owns the
    tile's rows r with r % units == u, and lane l of it the `vec` columns
    starting at group * cols + (l % lanes) * vec (those below F). With
    n_splits > 1 each block writes an fp32 partial and a second pass folds
    a tile's partials in segment order."""

    vec: int            # columns a lane loads at once; divides F
    lanes: int          # lanes of an owner unit (a power of two <= 32)
    warps: int          # warps of a block (a power of two)
    stage: int          # local_dst slots a shared-memory stage holds
    n_col_groups: int
    n_splits: int       # segments a tile
    seg: int            # slots a segment (a multiple of stage)
    smem: int           # dynamic shared memory bytes
    grid: int           # blocks

    @property
    def cols(self) -> int:
        return self.lanes * self.vec

    @property
    def units(self) -> int:
        return self.warps * (32 // self.lanes)

    @property
    def threads(self) -> int:
        return 32 * self.warps


def _smem_bytes(tile_v: int, cols: int, stage: int, warps: int,
                units: int) -> int:
    """A block's shared memory, as csrc/segment_reduce.cu:smem_bytes sizes
    it at launch (the plan needs it to choose `lanes`): the fp32
    accumulator, three local_dst stages, the counting sort's counts, unit
    starts and scan scratch, and its rank and order arrays."""
    return (tile_v * cols * 4 + 3 * stage * 4
            + (warps * units + units + 1 + 32) * 4 + 2 * stage * 2)


@functools.lru_cache(maxsize=256)
def _launch_plan(n_tiles: int, per_tile: int, tile_v: int, f: int,
                 dtype: torch.dtype, *, align: int = 16) -> LaunchPlan:
    """Size a launch for the kernel; raises ValueError on a shape it cannot
    cover (never a fallback). `align` is the messages' address alignment in
    bytes. A lane loads `vec` columns at once, 16 bytes where F and `align`
    allow; a unit spans the column group with `lanes` lanes (fewer when the
    [tile_v, cols] fp32 accumulator would not fit); narrow F packs 32 / lanes
    units into a warp, so at F=4 fp32 every lane owns rows of its own."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype}: the kernel takes {list(_DTYPES)}")
    if min(n_tiles, per_tile, tile_v, f) <= 0:
        raise ValueError(f"empty launch: n_tiles {n_tiles}, per_tile "
                         f"{per_tile}, tile_v {tile_v}, F {f}")
    b = dtype.itemsize
    vec = 16 // b
    while vec > 1 and (f % vec or align % (vec * b)):
        vec //= 2
    lanes = min(32, 1 << (math.ceil(f / vec) - 1).bit_length())
    stage = min(MAX_STAGE, -(-per_tile // 128) * 128)
    while True:
        # narrow F: 4 warps (128 units at F=4 fp32, 2 rows a lane) keep the
        # per-stage sort cheap; wide F: 16 warps keep loads in flight
        warps = 4 if lanes < 16 else MAX_THREADS // 32
        smem = _smem_bytes(tile_v, lanes * vec, stage, warps,
                           warps * (32 // lanes))
        if smem <= SMEM_LIMIT:
            break
        if lanes == 1:
            raise ValueError(f"tile_v {tile_v}: a [tile_v, {vec}] fp32 "
                             f"accumulator and its staging need {smem} B of "
                             f"shared memory, over {SMEM_LIMIT}")
        lanes //= 2
    n_col_groups = math.ceil(f / (lanes * vec))
    # segments: a tile with tens of thousands of real edges is not one
    # block's serial work
    n_splits = max(1, min(MAX_SPLITS, math.ceil(per_tile / SEG_SLOTS),
                          PARTIAL_BYTES // (n_tiles * tile_v * f * 4)))
    seg = -(-math.ceil(per_tile / n_splits) // stage) * stage
    n_splits = math.ceil(per_tile / seg)
    grid = n_tiles * n_splits * n_col_groups
    if grid > GRID_LIMIT:
        raise ValueError(f"{grid} blocks ({n_tiles} row tiles x {n_splits} "
                         f"segments x {n_col_groups} column groups) exceed "
                         f"{GRID_LIMIT}")
    return LaunchPlan(vec, lanes, warps, stage, n_col_groups, n_splits, seg,
                      smem, grid)


def _bind(lib: ctypes.CDLL) -> None:
    lib.segment_reduce.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
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
    plan = _launch_plan(n_tiles, e // n_tiles, tile_v, f, messages.dtype,
                        align=math.gcd(16, messages.data_ptr()))
    # fp32 partials of a split tile, folded by the kernel's second pass
    partial = (torch.empty(n_tiles * plan.n_splits * tile_v * f,
                           dtype=torch.float32, device=messages.device)
               if plan.n_splits > 1 else None)
    lib = LIBRARY.load()
    with torch.cuda.device(messages.device):
        stream = torch.cuda.current_stream(messages.device).cuda_stream
        rc = lib.segment_reduce(
            messages.data_ptr(), local_dst.data_ptr(), out.data_ptr(),
            None if partial is None else partial.data_ptr(),
            n_tiles, e // n_tiles, tile_v, f, _DTYPES[messages.dtype],
            COMBINERS.index(combiner), plan.vec, plan.lanes, plan.warps,
            plan.stage, plan.n_col_groups, plan.n_splits, plan.seg, stream)
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

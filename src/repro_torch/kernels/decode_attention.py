"""Single-token decode attention: the hand-written CUDA kernel, its wrapper,
its launch plan and its plain PyTorch version.

The kernel (csrc/decode_attention.cu) replaces the TPU kernel
repro/kernels/decode_attention.py:decode_attention. It is built at first use
(kernels/_build.py) and bound with ctypes; a failed build or launch raises.

`decode_attention` launches the kernel on CUDA tensors only;
`decode_attention_plain` computes the same function in plain PyTorch on any
device (kernels/ops.py dispatches). Both take folded tensors: q [BH, D],
k, v [BH, S, D], and `valid_len`, an int or a 0-d integer tensor. The kernel
reads `valid_len` from a device int32, so a call never waits for the host.
`LAUNCHES` counts the kernel's launches per (BH, S, D, dtype).

The kernel splits each bh's cache over `n_split` blocks (flash-decoding).
`_launch_plan` sizes a launch here in Python, where the CPU tests check it:
the tile of cache slots a ring stage holds, the ring's stages, `n_split`,
the grid, the shared memory and the fp32 workspace of the split partials.
`split_range` is the device's rule for the slots a split walks.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import CudaLibrary
from repro_torch.kernels.flash_attention import launch_inputs

HEAD_DIMS = (64, 80, 128)
# kernel launches per (BH, S, D, dtype); chip_smoke.py zeroes and reads them
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's constants (csrc/decode_attention.cu)
CONSUMERS = 4            # consumer warps a block (kConsumers)
THREADS = 32 * (CONSUMERS + 1)  # and one producer warp (kThreads)
STATES = 4 * CONSUMERS   # (m, l, acc) states a block merges (kStates)
SMEM_LIMIT = 232_448     # dynamic shared memory a block may use on an H100
GRID_LIMIT = 2**31 - 1
TILE_BYTES = 16 << 10    # a K (or V) tile: 16 KB (kTileBytes)
# the plan's choices: a 3-stage ring of 16 KB K and V tiles is 96 KB of
# shared memory a block, so two blocks share an SM (228 KB) and keep up
# to 192 KB in flight on it
STAGES = 3
BLOCKS_PER_SM = 2
MIN_SPLIT_TILES = 4      # tiles a split walks, at least (when S has them)
MAX_SPLIT = 64


@dataclass(frozen=True)
class DecodePlan:
    """One launch of csrc/decode_attention.cu: block b = bh * n_split +
    split walks the tiles `split_range` gives it, `tile` cache slots each,
    through a ring of `stages` K and V stages; with n_split > 1 it writes an
    fp32 partial (m, l, acc[D]) to the workspace and a second kernel folds
    a bh's partials in split order."""

    tile: int        # cache slots a ring stage holds
    stages: int      # ring stages
    n_split: int     # blocks a bh
    grid: int        # blocks of the first kernel (bh * n_split)
    smem: int        # dynamic shared memory bytes a block
    workspace: int   # fp32 elements of the split partials (0: none)


def _smem_bytes(tile: int, stages: int, d: int, itemsize: int) -> int:
    """A block's dynamic shared memory, as csrc/decode_attention.cu:
    smem_bytes lays it out (the entry refuses any other size): the K and V
    rings, the merge's m, l and acc of every state, a full and an empty
    mbarrier a stage."""
    return (2 * stages * tile * d * itemsize + STATES * (d + 2) * 4
            + 2 * stages * 8)


def split_range(n, tile: int, n_split: int, split: int):
    """The slots [lo, hi) that block `split` of a bh walks when the call
    walks n slots (n = min(valid_len, S), or S when valid_len <= 0): its
    share of the ceil(n / tile) tiles, cut on tile boundaries, the ragged
    last tile clipped at n. Empty (lo == hi) when the split gets no tile.
    The kernel's rule, in Python; `n` may also be an integer NumPy array
    (the tests sweep every n at once)."""
    nt = -(-n // tile)
    t_lo = split * nt // n_split
    t_hi = (split + 1) * nt // n_split
    return t_lo * tile, np.maximum(t_lo * tile, np.minimum(t_hi * tile, n))


def walked(valid_len: int, s: int) -> int:
    """The slots the kernel walks: min(valid_len, S), or all S when
    valid_len <= 0 (every slot masked alike: the mean of v)."""
    return min(valid_len, s) if valid_len >= 1 else s


@functools.lru_cache(maxsize=256)
def _launch_plan(bh: int, s: int, d: int, dtype: torch.dtype,
                 sm_count: int) -> DecodePlan:
    """Size a launch; raises ValueError on a shape the kernel cannot take
    (never a fallback). The host does not know valid_len and never syncs to
    learn it, so the plan is sized for all S slots.

    The tile holds at most TILE_BYTES of K in a multiple of STATES slots
    (64 at D 128 bf16, 96 at D 80: the kernel's kTile), the ring STAGES
    tiles of K and of V. n_split is the fewest
    splits that give every block slot of the card (SMs x BLOCKS_PER_SM) a
    block: 2 at BH 256 on 132 SMs, up to
    MAX_SPLIT at small BH, keeping MIN_SPLIT_TILES tiles a split where S
    has them. More splits only add blocks that each fill their ring anew,
    and partials to merge (chip_smoke.py times the main-path shape at
    other n_split beside the plan's)."""
    if dtype not in _DTYPES:
        raise TypeError(f"dtype {dtype}: the kernel takes {list(_DTYPES)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d}: the kernel takes {HEAD_DIMS}")
    if min(bh, s, sm_count) <= 0:
        raise ValueError(f"empty launch: BH {bh}, S {s}, {sm_count} SMs")
    tile = TILE_BYTES // (d * dtype.itemsize) // STATES * STATES
    tiles = -(-s // tile)
    n_split = -(-sm_count * BLOCKS_PER_SM // bh)
    n_split = max(1, min(n_split, MAX_SPLIT, max(tiles // MIN_SPLIT_TILES,
                                                 1)))
    grid = bh * n_split
    if grid > GRID_LIMIT:
        raise ValueError(f"{grid} blocks (BH {bh} x {n_split} splits) "
                         f"exceed {GRID_LIMIT}")
    workspace = bh * n_split * (d + 2) if n_split > 1 else 0
    return DecodePlan(tile, STAGES, n_split, grid,
                      _smem_bytes(tile, STAGES, d, dtype.itemsize), workspace)


@functools.lru_cache(maxsize=16)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _workspace(plan: DecodePlan, device) -> torch.Tensor | None:
    """The split partials' fp32 scratch the wrapper hands the kernel."""
    if not plan.workspace:
        return None
    return torch.empty(plan.workspace, dtype=torch.float32, device=device)


def _bind(lib: ctypes.CDLL) -> None:
    lib.decode_attention.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
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
    plan = _launch_plan(bh, s, d, q.dtype, _sm_count(q.device))
    out = _launch(q, k, v, _valid_on(valid_len, q.device), plan)
    LAUNCHES[(bh, s, d, str(q.dtype).removeprefix("torch."))] += 1
    return out


def _launch(q, k, v, valid: torch.Tensor, plan: DecodePlan) -> torch.Tensor:
    """One launch under `plan` on checked inputs (`valid` one device
    int32); raises if the entry refuses the plan or the launch fails."""
    bh, s, d = k.shape
    out = torch.empty_like(q)
    work = _workspace(plan, q.device)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
            out.data_ptr(), None if work is None else work.data_ptr(), bh, s,
            d, _DTYPES[q.dtype], 1.0 / math.sqrt(d), plan.tile, plan.stages,
            plan.n_split, plan.smem, stream)
    LIBRARY.check(rc, "decode_attention")
    return out


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid_len) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device: the oracle on
    the folded tensors."""
    _check_shapes(q, k, v, valid_len)
    return ref.decode_attention_ref(q[None], k[None], v[None], valid_len)[0]

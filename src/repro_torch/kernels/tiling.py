# Copy of repro/kernels/tiling.py (NumPy only), imports redirected to repro_torch;
# tests/test_torch_host.py holds its results equal to the original.
"""Host-side tiled-edge layout for the segment-SpMM kernel (pure NumPy).

Kept jax-free on purpose: the partition books and the mini-batch sampler run
in the host/preprocessing layer (core/, gnn/sampling.py), which must not pay
the jax import just to sort edge lists. The device-side wrappers
(kernels/ops.py) re-export everything here.
"""

from __future__ import annotations

import numpy as np

DEFAULT_BLOCK_E = 512
DEFAULT_TILE_V = 256
DEFAULT_TILE_F = 128


def tiled_shape(num_rows: int, tile_v: int = DEFAULT_TILE_V) -> tuple[int, int]:
    """(rows_padded, n_tiles) of a tiled layout over `num_rows` rows — the
    ONE place this padding rule lives; every consumer (layout pass, kernel
    wrapper, partition book, sample plan) derives shapes from here."""
    rows_padded = int(np.ceil(max(num_rows, 1) / tile_v) * tile_v)
    return rows_padded, rows_padded // tile_v


def _check_dst_range(vdst: np.ndarray, num_rows: int, rows_padded: int) -> None:
    """Every (valid) destination must land inside the padded row range —
    edges past it would fall into row tiles the kernel grid never visits and
    silently vanish from the aggregate."""
    if vdst.size == 0:
        return
    lo, hi = int(vdst.min()), int(vdst.max())
    if lo < 0 or hi >= rows_padded:
        raise ValueError(
            f"tiled layout: dst out of range [0, {rows_padded}) "
            f"(num_rows={num_rows} padded to {rows_padded}); got "
            f"min={lo}, max={hi}. Edges aimed past the padded row range "
            f"would be silently dropped — mask them out via `valid` or "
            f"route them to an in-range padding sink row."
        )


def tiled_need_per_tile(
    dst: np.ndarray,
    num_rows: int,
    *,
    tile_v: int = DEFAULT_TILE_V,
    block_e: int = DEFAULT_BLOCK_E,
    valid: np.ndarray | None = None,
) -> int:
    """Smallest legal `per_tile` for this edge list — the block-rounded max
    per-tile edge count — without building the layout (O(E) bincount)."""
    rows_padded, n_tiles = tiled_shape(num_rows, tile_v)
    vdst = np.asarray(dst if valid is None else dst[valid], dtype=np.int64)
    _check_dst_range(vdst, num_rows, rows_padded)
    counts = np.bincount(vdst // tile_v, minlength=n_tiles)
    blocks = int(np.ceil(counts.max() / block_e)) if counts.size else 0
    return max(blocks, 1) * block_e


def prepare_tiled_edges(
    dst: np.ndarray,
    num_rows: int,
    *,
    tile_v: int = DEFAULT_TILE_V,
    block_e: int = DEFAULT_BLOCK_E,
    per_tile: int | None = None,
    valid: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side layout pass (once per graph/partition): sort edges by row
    tile and pad each tile's edge list to a multiple of block_e.

    Returns (edge_order, local_dst, rows_padded):
      edge_order [E_padded] — gather indices into the original edge list
                              (padding -> E, caller appends a zero message row)
      local_dst  [E_padded] — row id within the edge's tile (padding -> tile_v)

    `valid` (bool[E]) drops edges from the layout entirely; only edges whose
    messages carry the combiner identity (zero for sum, <= any real score for
    max) may be dropped (the aggregate stays exact). `per_tile` forces every
    tile's padded edge count, so several partitions / batches can share one
    static device shape; it must be a multiple of block_e and at least the
    largest per-tile edge count (`tiled_need_per_tile`).

    Every valid dst must lie in [0, rows_padded) — anything past the padded
    row range raises ValueError rather than silently vanishing from the
    aggregate (its row tile would sit outside the kernel grid).
    """
    e = dst.shape[0]
    rows_padded, n_tiles = tiled_shape(num_rows, tile_v)
    if valid is None:
        idx = np.arange(e, dtype=np.int64)
        vdst = np.asarray(dst, dtype=np.int64)
    else:
        idx = np.where(valid)[0].astype(np.int64)
        vdst = np.asarray(dst, dtype=np.int64)[idx]
    _check_dst_range(vdst, num_rows, rows_padded)
    tile_of = vdst // tile_v
    order = np.argsort(tile_of, kind="stable")
    counts = np.bincount(tile_of, minlength=n_tiles)
    # every tile gets the same number of edge blocks (grid uniformity)
    need = int(max(int(np.ceil(counts.max() / block_e)) if counts.size else 0, 1))
    need *= block_e
    if per_tile is None:
        per_tile = need
    else:
        assert per_tile % block_e == 0 and per_tile >= need, (per_tile, need)
    total = per_tile * n_tiles
    edge_order = np.full(total, e, dtype=np.int64)
    local_dst = np.full(total, tile_v, dtype=np.int32)
    starts = np.cumsum(counts) - counts
    for t in range(n_tiles):
        seg = order[starts[t]: starts[t] + counts[t]]
        edge_order[t * per_tile: t * per_tile + counts[t]] = idx[seg]
        local_dst[t * per_tile: t * per_tile + counts[t]] = (
            vdst[seg] - t * tile_v
        ).astype(np.int32)
    return edge_order, local_dst, rows_padded

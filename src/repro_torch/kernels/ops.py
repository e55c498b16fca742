"""Public wrappers for the kernels, with device dispatch.

Twin of repro/kernels/ops.py (segment_spmm, aggregate, flash_attention,
decode_attention). On a CUDA tensor the tiled path and the attention ops
launch the hand-written kernels (kernels/segment_spmm.py,
flash_attention.py, decode_attention.py); on a CPU tensor they compute the
same function in plain PyTorch. "pallas", the reference's name for "force
the kernel", keeps that meaning here (the aggregate backend, the attention
ops' `use_pallas=True`), so one `GNNSpec` runs in both packages: it
launches the kernel and raises on a CPU tensor. Forward only: the kernel
paths raise if a gradient is requested.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ref
from repro_torch.kernels import segment_spmm as _spmm
from repro_torch.kernels.tiling import DEFAULT_BLOCK_E, DEFAULT_TILE_V, tiled_shape

AGG_BACKENDS = ("scatter", "tiled", "pallas")
AGG_REDUCES = ("sum", "max")


def segment_spmm(
    messages: torch.Tensor,
    local_dst: torch.Tensor,
    num_rows: int,
    *,
    combiner: str = "sum",
    tile_v: int = DEFAULT_TILE_V,
    block_e: int = DEFAULT_BLOCK_E,
) -> torch.Tensor:
    """Tiled segment reduce (`combiner` in {"sum", "max"}) over a
    `prepare_tiled_edges` layout built with the same (tile_v, block_e).
    `num_rows` may be unpadded: the grid comes from `tiled_shape` and the
    result is [num_rows, F]. A CUDA tensor launches the kernel; a CPU
    tensor takes the plain version."""
    e = messages.shape[0]
    rows_padded, n_tiles = tiled_shape(num_rows, tile_v)
    assert e % n_tiles == 0, (
        f"tiled layout mismatch: {e} edges do not split over {n_tiles} row "
        f"tiles (num_rows={num_rows}, tile_v={tile_v}); was the layout built "
        f"with a different (num_rows, tile_v)?")
    if messages.is_cuda:
        out = _spmm.segment_spmm(messages, local_dst, rows_padded,
                                 combiner=combiner, tile_v=tile_v,
                                 block_e=block_e)
    else:
        out = _spmm.segment_spmm_plain(messages, local_dst, rows_padded,
                                       combiner=combiner, tile_v=tile_v)
    return out[:num_rows]


def aggregate(
    messages: torch.Tensor,   # [E, F] per-edge messages (original edge order)
    dst: torch.Tensor,        # [E] destination row per edge (<= num_rows)
    num_rows: int,
    *,
    edge_order: torch.Tensor | None = None,  # int64, from prepare_tiled_edges
    local_dst: torch.Tensor | None = None,   # int32
    backend: str = "scatter",
    reduce: str = "sum",
    tile_v: int = DEFAULT_TILE_V,
    block_e: int = DEFAULT_BLOCK_E,
) -> torch.Tensor:
    """Segment-reduce `messages` into `[num_rows, F]` vertex rows.

    backend:
      scatter — index_add_ / scatter_reduce_(amax) on the original edge
                order, any device; dst == num_rows is a sink row
      tiled   — gather into the `prepare_tiled_edges` layout, then the
                kernel (CUDA tensors) or its plain version (CPU tensors)
      pallas  — like tiled but always the kernel: raises on CPU tensors

    reduce: sum (identity 0) or max (identity -inf: rows no edge reaches
    come back as -inf; the tiled layout drops `valid`-masked edges, so
    callers clamp against a finite floor, as the GAT layers do).
    """
    if reduce not in AGG_REDUCES:
        raise ValueError(f"unknown aggregate reduce {reduce!r}; "
                         f"options: {AGG_REDUCES}")
    if backend == "scatter":
        idx = torch.clamp(dst.long(), max=num_rows)
        if reduce == "max":
            return ref.segment_max_ref(messages, idx, num_rows)
        return ref.segment_sum_ref(messages, idx, num_rows)
    if backend not in AGG_BACKENDS:
        raise ValueError(f"unknown aggregate backend {backend!r}; "
                         f"options: {AGG_BACKENDS}")
    assert edge_order is not None and local_dst is not None, (
        "tiled/pallas backends need the prepare_tiled_edges layout")
    if edge_order.shape[-1] == 0 and messages.shape[0] > 0:
        raise ValueError(
            "empty tiled layout: the partition book / sample plan was built "
            "without tiled_layout=True but a tiled backend was requested")
    if backend == "pallas" and not messages.is_cuda:
        raise ValueError("backend 'pallas' forces the CUDA kernel; got a "
                         f"tensor on {messages.device}")
    # the pad row the layout's pad edges gather: the reduce identity
    fill = 0.0 if reduce == "sum" else float("-inf")
    msg_pad = torch.cat(
        [messages, messages.new_full((1, messages.shape[1]), fill)])
    return segment_spmm(
        msg_pad.index_select(0, edge_order), local_dst, num_rows,
        combiner=reduce, tile_v=tile_v, block_e=block_e)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def _use_kernel(x: torch.Tensor, use_pallas: bool | None) -> bool:
    """None: the kernel for a CUDA tensor, the plain version for a CPU one.
    True forces the kernel (raises on a CPU tensor); False the plain one."""
    if use_pallas is None:
        return x.is_cuda
    if use_pallas and not x.is_cuda:
        raise ValueError("use_pallas=True forces the CUDA kernel; got a "
                         f"tensor on {x.device}")
    return bool(use_pallas)


def flash_attention(
    q: torch.Tensor,  # [B, H, Sq, D]
    k: torch.Tensor,  # [B, H, Skv, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """Forward attention, [B, H, Sq, D] in q's dtype. A causal call needs
    Sq == Skv (raises ValueError otherwise, on both paths)."""
    b, h, sq, d = q.shape
    fn = (_flash.flash_attention if _use_kernel(q, use_pallas)
          else _flash.flash_attention_plain)
    fold = lambda x: x.reshape(b * h, x.shape[2], d)  # noqa: E731
    return fn(fold(q), fold(k), fold(v), causal=causal).reshape(b, h, sq, d)


def decode_attention(
    q: torch.Tensor,  # [B, H, D]
    k: torch.Tensor,  # [B, H, S, D]
    v: torch.Tensor,
    valid_len,        # int or 0-d integer tensor
    *,
    use_pallas: bool | None = None,
) -> torch.Tensor:
    """One query row per (batch, head) against the cache, [B, H, D]; cache
    slots >= valid_len are masked out."""
    b, h, s, d = k.shape
    fn = (_decode.decode_attention if _use_kernel(q, use_pallas)
          else _decode.decode_attention_plain)
    return fn(q.reshape(b * h, d), k.reshape(b * h, s, d),
              v.reshape(b * h, s, d), valid_len).reshape(b, h, d)
